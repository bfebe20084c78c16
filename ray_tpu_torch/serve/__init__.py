"""ray_tpu_torch.serve — scalable model serving on the cluster runtime.

Parity target: reference python/ray/serve (deployment decorator + .bind
application graphs, serve.run, DeploymentHandle composition, @serve.batch,
autoscaling, HTTP ingress). The serving half of the TPU-era value
proposition: replicas are async actors whose event loops interleave
requests, the controller reconciles declared state, and routing uses
power-of-two-choices over long-polled membership.

Counterpart: ray_tpu/serve/__init__.py (copied).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._private.controller import (
    CONTROLLER_NAME,
    PROXY_NAME,
    ServeController,
)
from ray_tpu_torch.serve._private.replica import Request
from ray_tpu_torch.serve._private.router import (
    DeploymentHandle,
    DeploymentResponse,
    reset_routers,
)

__all__ = [
    "Application",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "Request",
    "batch",
    "delete",
    "get_multiplexed_model_id",
    "multiplexed",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "proxy_ports",
    "run",
    "shutdown",
    "status",
]


@dataclass
class Application:
    """A bound deployment (+ its bound argument subgraph) — reference
    serve built-application graphs (Deployment.bind)."""

    deployment: "Deployment"
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)


class Deployment:
    def __init__(self, func_or_class, name: str, num_replicas=1,
                 ray_actor_options: Optional[dict] = None,
                 max_ongoing_requests: int = 16,
                 autoscaling_config: Optional[dict] = None,
                 version: Optional[str] = None,
                 max_queued_requests: int = -1,
                 queue_deadline_s: Optional[float] = None):
        self._func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options
        self.max_ongoing_requests = max_ongoing_requests
        self.autoscaling_config = autoscaling_config
        self.version = version
        # Admission budgets (README "Overload & admission control"):
        # max_queued_requests bounds the per-router queue behind the
        # replicas' concurrency caps (-1 = unbounded, the deadline still
        # sheds); queue_deadline_s caps how long a request may wait for a
        # slot before it is shed (None = RT_SERVE_QUEUE_DEADLINE_S).
        self.max_queued_requests = max_queued_requests
        self.queue_deadline_s = queue_deadline_s

    def options(self, **overrides) -> "Deployment":
        cfg = dict(
            name=self.name, num_replicas=self.num_replicas,
            ray_actor_options=self.ray_actor_options,
            max_ongoing_requests=self.max_ongoing_requests,
            autoscaling_config=self.autoscaling_config, version=self.version,
            max_queued_requests=self.max_queued_requests,
            queue_deadline_s=self.queue_deadline_s)
        cfg.update(overrides)
        return Deployment(self._func_or_class, **cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def _spec(self, route_prefix: Optional[str], args: tuple,
              kwargs: dict) -> dict:
        import cloudpickle

        version = self.version or hashlib.sha1(
            cloudpickle.dumps(self._func_or_class)).hexdigest()[:12]
        num_replicas = self.num_replicas
        autoscaling = self.autoscaling_config
        if num_replicas == "auto" and autoscaling is None:
            autoscaling = {"min_replicas": 1, "max_replicas": 4,
                           "target_ongoing_requests": 2}
        return {
            "name": self.name,
            "callable": self._func_or_class,
            "init_args": args,
            "init_kwargs": kwargs,
            "num_replicas": 1 if num_replicas == "auto" else num_replicas,
            "autoscaling_config": autoscaling,
            "ray_actor_options": self.ray_actor_options,
            "max_ongoing_requests": self.max_ongoing_requests,
            "max_queued_requests": self.max_queued_requests,
            "queue_deadline_s": self.queue_deadline_s,
            "route_prefix": route_prefix,
            "version": version,
        }


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas=1, ray_actor_options: Optional[dict] = None,
               max_ongoing_requests: int = 16,
               autoscaling_config: Optional[dict] = None,
               version: Optional[str] = None,
               max_queued_requests: int = -1,
               queue_deadline_s: Optional[float] = None):
    """@serve.deployment (reference api.py:deployment)."""

    def wrap(fc):
        return Deployment(fc, name or fc.__name__, num_replicas,
                          ray_actor_options, max_ongoing_requests,
                          autoscaling_config, version,
                          max_queued_requests, queue_deadline_s)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


# ------------------------------------------------------------------ control
def _get_or_create_controller():
    wrapped = ray_tpu_torch.remote(num_cpus=0, max_concurrency=64)(ServeController)
    return wrapped.options(name=CONTROLLER_NAME, lifetime="detached",
                           get_if_exists=True).remote()


def _deploy_app(app: Application, controller, route_prefix: Optional[str],
                seen: dict) -> str:
    """Deploy `app` and (recursively) every Application bound into its
    args, replacing them with DeploymentHandles (model composition —
    reference build_app / handle injection)."""

    def resolve(v):
        if isinstance(v, Application):
            dep_name = _deploy_app(v, controller, None, seen)
            return DeploymentHandle(dep_name, CONTROLLER_NAME)
        return v

    if id(app) in seen:
        return seen[id(app)]
    args = tuple(resolve(a) for a in app.args)
    kwargs = {k: resolve(v) for k, v in app.kwargs.items()}
    spec = app.deployment._spec(route_prefix, args, kwargs)
    ray_tpu_torch.get(controller.deploy.remote(spec), timeout=30)
    seen[id(app)] = spec["name"]
    return spec["name"]


def run(target: Application, *, route_prefix: str = "/",
        host: str = "127.0.0.1", port: int = 8000,
        grpc_port: Optional[int] = None, num_proxies: Optional[int] = None,
        _blocking: bool = True, timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy an application and start the HTTP ingress (reference
    serve/api.py:run). grpc_port (0 = auto-pick) additionally starts the
    gRPC ingress (reference gRPCProxy, proxy.py:530): unary calls at
    /ray_tpu_torch.serve.<deployment>/<method>, server streaming with the
    'Stream' method suffix.

    num_proxies (default RT_SERVE_PROXIES, normally 1) fans the HTTP
    ingress out across N proxy processes: proxy 0 keeps the requested
    `port` (and the classic PROXY_NAME, so single-proxy behavior is
    unchanged), extras auto-bind free ports discoverable via
    serve.proxy_ports(). Each proxy runs its own admission queues against
    the same controller-published budgets — the replica-side concurrency
    cap is the shared backstop (README "Cross-host streaming &
    multi-proxy")."""
    from ray_tpu_torch._private.rtconfig import CONFIG

    if not isinstance(target, Application):
        raise TypeError("serve.run expects Deployment.bind(...)")
    if num_proxies is None:
        num_proxies = int(CONFIG.serve_proxies)
    num_proxies = max(1, num_proxies)
    controller = _get_or_create_controller()
    ingress = _deploy_app(target, controller, route_prefix, {})
    # HTTP proxy fleet (reference runs one per node).
    from ray_tpu_torch.serve._private.proxy import Proxy

    proxy_cls = ray_tpu_torch.remote(num_cpus=0, max_concurrency=64)(Proxy)
    proxies = []
    for i in range(num_proxies):
        name = PROXY_NAME if i == 0 else f"{PROXY_NAME}_{i}"
        proxies.append(proxy_cls.options(
            name=name, lifetime="detached", get_if_exists=True).remote(
            CONTROLLER_NAME, host, port if i == 0 else 0,
            grpc_port if i == 0 else None, proxy_id=name))
    for proxy in proxies:
        ray_tpu_torch.get(proxy.ready.remote(), timeout=30)
    if grpc_port is not None:
        # The proxy may predate this run (get_if_exists reuses it with the
        # FIRST run's constructor args): start the ingress in-place.
        ray_tpu_torch.get(proxies[0].ensure_grpc.remote(grpc_port), timeout=30)
    if _blocking:
        deadline = time.monotonic() + timeout_s
        st: dict = {}
        while time.monotonic() < deadline:
            st = ray_tpu_torch.get(controller.status.remote(), timeout=10)
            if all(d["status"] == "RUNNING" for d in st.values()):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(f"deployments not ready after {timeout_s}s: {st}")
    return DeploymentHandle(ingress, CONTROLLER_NAME)


def get_grpc_port() -> Optional[int]:
    """Bound gRPC ingress port of the running proxy (None if disabled)."""
    proxy = ray_tpu_torch.get_actor(PROXY_NAME)
    return ray_tpu_torch.get(proxy.grpc_ready.remote(), timeout=10)


def proxy_ports() -> dict:
    """proxy_id -> bound HTTP port for every proxy registered with the
    controller. With num_proxies=1 this is {PROXY_NAME: port}; with a
    fleet, clients (or an external load balancer) spread connections
    across the returned ports."""
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    reg = ray_tpu_torch.get(controller.list_proxies.remote(), timeout=10)
    return {pid: info["port"] for pid, info in reg.items()}


def status() -> dict:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.status.remote(), timeout=10)


def get_deployment_handle(deployment_name: str, app_name: str = "") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, CONTROLLER_NAME)


get_app_handle = get_deployment_handle


def delete(name: str):
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete.remote(name), timeout=30)


def shutdown():
    """Tear down all deployments, every registered proxy, and the
    controller."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        reset_routers()
        return
    proxy_names = [PROXY_NAME]
    try:
        reg = ray_tpu_torch.get(controller.list_proxies.remote(), timeout=10)
        proxy_names += [p for p in reg if p != PROXY_NAME]
    except Exception:
        pass
    try:
        ray_tpu_torch.get(controller.shutdown_all.remote(), timeout=30)
    except Exception:
        pass
    for name in (*proxy_names, CONTROLLER_NAME):
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
        except Exception:
            pass
    reset_routers()


# ------------------------------------------------------------------- batch
def batch(_func=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """@serve.batch (reference serve/batching.py): concurrent calls to the
    wrapped async method are buffered and delivered as ONE call with a list
    argument; each caller gets its element of the returned list. The
    batch-inference pattern for the MXU: many small requests fuse into one
    large matmul-shaped call."""

    def wrap(func):
        state_attr = f"__serve_batch_{func.__name__}"

        @functools.wraps(func)
        async def wrapper(self, item):
            # Everything here runs on ONE event loop (the replica's), so the
            # queue/drainer handoff needs no locks: a coroutine can only be
            # interleaved at its awaits.
            st = getattr(self, state_attr, None)
            if st is None:
                st = {"queue": [], "wake": asyncio.Event(), "drainer": None}
                setattr(self, state_attr, st)
            fut = asyncio.get_event_loop().create_future()
            st["queue"].append((item, fut))
            if len(st["queue"]) >= max_batch_size:
                st["wake"].set()
            if st["drainer"] is None or st["drainer"].done():
                st["drainer"] = asyncio.ensure_future(_drain(self, st))
            return await fut

        async def _drain(self_obj, st):
            """Lives while there is work; flushes one batch per round. A
            batch in flight is never cancelled, and items arriving during a
            flush are picked up by the next round (the while-check and the
            task's completion are atomic w.r.t. the loop, so wrapper's
            done()-check can't miss work)."""
            while st["queue"]:
                st["wake"] = asyncio.Event()
                if len(st["queue"]) < max_batch_size:
                    try:
                        await asyncio.wait_for(st["wake"].wait(),
                                               timeout=batch_wait_timeout_s)
                    except asyncio.TimeoutError:
                        pass
                batch = st["queue"][:max_batch_size]
                st["queue"] = st["queue"][max_batch_size:]
                try:
                    outs = await func(self_obj, [b[0] for b in batch])
                    if len(outs) != len(batch):
                        raise ValueError(
                            f"@serve.batch function returned {len(outs)} "
                            f"results for {len(batch)} inputs")
                    for (_i, fut), out in zip(batch, outs):
                        if not fut.done():
                            fut.set_result(out)
                except Exception as e:
                    for _i, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)

        return wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


# --------------------------------------------------------------- multiplex
def get_multiplexed_model_id() -> str:
    """Model id of the request currently being handled (reference
    serve.get_multiplexed_model_id) — set by handle.options(
    multiplexed_model_id=...) or the `serve_multiplexed_model_id` HTTP
    header."""
    from ray_tpu_torch.serve._private.replica import _multiplexed_model_id

    return _multiplexed_model_id.get()


def multiplexed(_func=None, *, max_num_models_per_replica: int = 3):
    """Decorator for a deployment's model-loader method (reference
    serve/multiplex.py @serve.multiplexed): caches up to
    `max_num_models_per_replica` loaded models per replica with LRU
    eviction, so one replica pool serves many fine-tuned model variants.

    Usage::

        @serve.deployment
        class Multi:
            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id: str):
                return load_model(model_id)

            async def __call__(self, request):
                model = await self.get_model(serve.get_multiplexed_model_id())
                return model.predict(request.json())
    """

    def deco(fn):
        cache_attr = f"__rt_mux_cache_{fn.__name__}"
        is_coro = asyncio.iscoroutinefunction(fn)

        async def _load(self, model_id: str):
            # Replica requests interleave on ONE event loop; the cache maps
            # model_id -> Future so concurrent requests for the same model
            # await a single in-flight load instead of double-loading.
            # Eviction pops the reference and lets GC reclaim the model once
            # the last in-flight request drops it (calling a release hook
            # here would tear down a model another request is still using).
            cache = getattr(self, cache_attr, None)
            if cache is None:
                cache = {}
                setattr(self, cache_attr, cache)
            fut = cache.get(model_id)
            if fut is not None:
                cache[model_id] = cache.pop(model_id)  # LRU touch
                return await asyncio.shield(fut)
            loop = asyncio.get_event_loop()
            fut = loop.create_future()
            cache[model_id] = fut
            try:
                if is_coro:
                    model = await fn(self, model_id)
                else:
                    # A sync loader must not freeze the replica's event loop
                    # for the duration of a model load.
                    model = await loop.run_in_executor(
                        None, functools.partial(fn, self, model_id))
            except BaseException as e:
                cache.pop(model_id, None)
                if not fut.done():
                    fut.set_exception(e)
                    # consumed by any concurrent waiter; don't warn if not
                    fut.exception()
                raise
            fut.set_result(model)
            while len(cache) > max_num_models_per_replica:
                for mid in list(cache):
                    if mid != model_id and cache[mid].done():
                        del cache[mid]
                        break
                else:
                    break  # everything else still loading: nothing to evict
            return model

        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            return await _load(self, model_id)

        wrapper.__rt_multiplexed__ = True
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco
