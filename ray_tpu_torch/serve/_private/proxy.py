"""HTTP proxy: aiohttp server actor routing requests to deployments.

Parity target: reference python/ray/serve/_private/proxy.py:750 (ProxyActor
hosting an HTTP server per node; route table via long-poll; request ->
router -> replica; response assembly :1137). The server runs on the
replica actor's own asyncio loop (async actor), so request handling and
response awaits interleave without threads-per-request.

Counterpart: ray_tpu/serve/_private/proxy.py (copied; its ring sweep
looks for the port's ring names, and a streamed request's set-up is one
span of its trace, `serve.stream_assign`).
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import math
import os
import threading
import time
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch._private import tracing as _tracing
from ray_tpu_torch._private.rtconfig import CONFIG
from ray_tpu_torch.serve._private.replica import Request
from ray_tpu_torch.serve._private.router import (
    QueueCancelled,
    _is_replica_busy,
    _retry_pause_s,
    get_router,
    resolver_for,
)

logger = logging.getLogger(__name__)


class _TokenBucket:
    """Burst-tolerant per-route rate limiter (RT_SERVE_RPS/RT_SERVE_BURST,
    README "Overload & admission control"): refills continuously at `rate`
    tokens/s up to `burst`, so short bursts pass at line rate and only
    sustained excess is shed — before it ever touches the router queue."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = float(burst)
        self.stamp = now

    def take(self, now: float) -> float:
        """0.0 when a token was taken; else seconds until one refills."""
        self.tokens = min(float(self.burst),
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / max(self.rate, 1e-9)


class Proxy:
    def __init__(self, controller_name: str, host: str = "127.0.0.1",
                 port: int = 8000, grpc_port: Optional[int] = None,
                 proxy_id: str = ""):
        self.controller_name = controller_name
        self.host, self.port = host, port
        self.grpc_port = grpc_port  # None = gRPC ingress off
        self._grpc_ingress = None
        # Identity in the controller's proxy registry / metric tags; the
        # default keeps single-proxy deployments stable across restarts.
        self.proxy_id = proxy_id or "_serve_proxy"
        self.routes: dict[str, str] = {}
        self._version = -1
        self._site = None
        self._started = False
        self._resolver = None
        self._stream_pool = None  # dedicated: SSE waits pin a thread each
        # route prefix -> token bucket (RT_SERVE_RPS); rebuilt when the
        # knobs change so tests can flip rates without a proxy restart.
        self._buckets: dict[str, _TokenBucket] = {}
        # deployment -> monotonic time of its last ring-handshake nak: a
        # peer that cannot attach (cross-host replica, no shared shm)
        # naks every request, so skip the 1MB ring setup/unlink for a
        # while instead of paying it per stream. Time-bounded (not
        # permanent) so a transient failure can't disable the ring path
        # for a deployment forever. With the push transport armed a
        # remote replica answers "push" instead of nakking, so this
        # backoff only fires when BOTH transports are out.
        self._ring_nak: dict[str, float] = {}
        # Push-stream hub (lazy; README "Cross-host streaming"): ONE rpc
        # server per proxy process accepting token-record frames from
        # replicas that cannot attach the shm ring.
        self._hub = None
        self._active_streams = 0
        # (monotonic, [proxy names]) — controller proxy-registry cache so
        # /v1/stats aggregation costs one controller round trip per ~2s,
        # not per request.
        self._proxy_registry_cache: tuple[float, list] = (-1e9, [])

    def _sweep_dead_rings(self) -> None:
        """Unlink /dev/shm stream-ring segments left by proxies that died
        without running their per-stream unlink (a SIGKILLed proxy leaks
        one ring segment per open stream). Ring names embed the creator
        pid, so a segment is debris exactly when that pid is gone — live
        proxies' rings are never touched."""
        import glob

        from ray_tpu_torch.dag.stream import RING_PREFIX

        for path in glob.glob(f"/dev/shm/{RING_PREFIX}sse_*"):
            stem = os.path.basename(path)[len(f"{RING_PREFIX}sse_"):]
            try:
                pid = int(stem.split("_", 1)[0])
            except ValueError:
                continue  # foreign or pre-pid naming: leave it alone
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            except PermissionError:
                pass  # alive under another uid

    async def ready(self) -> int:
        """Bind the HTTP server; returns the bound port."""
        if self._started:
            return self.port
        from aiohttp import web

        self._sweep_dead_rings()

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        # handler_cancellation: aiohttp >= 3.9 no longer cancels handler
        # tasks when the client disconnects. The admission plane depends
        # on that cancellation to free QUEUED slots for abandoned
        # requests, so re-enable it — only with the plane on, keeping the
        # legacy path byte-identical.
        runner = web.AppRunner(app, access_log=None,
                               handler_cancellation=bool(
                                   CONFIG.serve_admission))
        await runner.setup()
        site = web.TCPSite(runner, self.host, self.port)
        await site.start()
        self._site = site
        self._started = True
        if self.port == 0:
            # Auto-bound (extra proxies of a multi-proxy fleet): report
            # the real port so serve.proxy_ports() can route clients.
            try:
                self.port = site._server.sockets[0].getsockname()[1]
            except Exception:
                pass
        self._resolver = resolver_for(asyncio.get_event_loop())
        # Populate the route table BEFORE declaring ready: serve.run
        # returns right after this, and the first request must not race
        # the initial long-poll to a 404.
        try:
            controller = ray_tpu_torch.get_actor(self.controller_name)
            ref = controller.route_table.remote(-1, 0.0)
            rep = await asyncio.get_event_loop().run_in_executor(
                None, lambda r=ref: ray_tpu_torch.get(r, timeout=10))
            self._version = rep["version"]
            self.routes = rep["routes"]
        except Exception as e:
            logger.warning("serve proxy initial route fetch failed: %r", e)
        # Join the controller's proxy registry: /v1/stats aggregation and
        # serve.shutdown() discover the fleet there, and a RESTARTED proxy
        # re-registers here — rejoining routing exactly like it joined.
        try:
            import os as _os

            controller = ray_tpu_torch.get_actor(self.controller_name)
            ref = controller.register_proxy.remote(
                self.proxy_id, self.host, self.port, _os.getpid())
            await asyncio.get_event_loop().run_in_executor(
                None, lambda r=ref: ray_tpu_torch.get(r, timeout=5))
            from ray_tpu_torch._private.events import emit_event

            emit_event("serve_proxy_join",
                       f"proxy {self.proxy_id!r} serving "
                       f"{self.host}:{self.port}",
                       entity=(self.proxy_id,),
                       attrs={"port": self.port, "pid": _os.getpid()})
        except Exception as e:
            logger.debug("serve proxy registration skipped: %r", e)
        if self.grpc_port is not None and self._grpc_ingress is None:
            from ray_tpu_torch.serve._private.grpc_proxy import GrpcIngress

            self._grpc_ingress = GrpcIngress(self, self.host, self.grpc_port)
            self.grpc_port = self._grpc_ingress.port
        asyncio.ensure_future(self._route_poll_loop())
        return self.port

    async def grpc_ready(self) -> Optional[int]:
        """Bound gRPC ingress port (None when disabled)."""
        return self.grpc_port

    async def ensure_grpc(self, grpc_port: Optional[int]) -> Optional[int]:
        """Start the gRPC ingress on an ALREADY-RUNNING proxy (serve.run
        reuses the detached proxy actor, so constructor args from the
        first run would otherwise silently win over a later grpc_port)."""
        if grpc_port is not None and self._grpc_ingress is None:
            from ray_tpu_torch.serve._private.grpc_proxy import GrpcIngress

            self._grpc_ingress = GrpcIngress(self, self.host, grpc_port)
            self.grpc_port = self._grpc_ingress.port
        return self.grpc_port

    async def _route_poll_loop(self):
        while True:
            try:
                controller = ray_tpu_torch.get_actor(self.controller_name)
                ref = controller.route_table.remote(self._version, 10.0)
                rep = await asyncio.get_event_loop().run_in_executor(
                    None, lambda r=ref: ray_tpu_torch.get(r, timeout=15))
                self._version = rep["version"]
                self.routes = rep["routes"]
            except Exception as e:
                logger.debug("serve proxy route poll error: %r", e)
                await asyncio.sleep(0.2)

    def _match(self, path: str) -> Optional[tuple[str, str]]:
        best = None
        for prefix, dep in self.routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(norm + "/") or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, dep)
        return best

    def _pool(self):
        if self._stream_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # NOT the default executor: each active stream parks a thread
            # in next() for its whole lifetime — and with admission on,
            # queued assigns park one up to the deadline — so exhausting
            # the shared pool would stall every other run_in_executor user
            # (route polls, legacy assigns) behind long waits.
            self._stream_pool = ThreadPoolExecutor(
                max_workers=256, thread_name_prefix="rt-sse")
        return self._stream_pool

    async def _ensure_hub(self):
        """Lazy per-process push-stream hub: nothing binds (or costs a
        frame) until the first streaming request with the push transport
        armed."""
        if self._hub is None:
            from ray_tpu_torch.dag.push_stream import PushStreamHub

            hub = PushStreamHub()
            host = self.host if self.host not in ("0.0.0.0", "::") \
                else "127.0.0.1"
            await hub.start(host)
            self._hub = hub
        return self._hub

    async def admission_snapshot(self, deployment: str) -> dict:
        """This process's admission/stream counters — the unit /v1/stats
        aggregation sums across the proxy fleet."""
        import os as _os

        router = get_router(self.controller_name, deployment)
        snap = dict(router.admission_stats() or {})
        snap["pid"] = _os.getpid()
        snap["active_streams"] = self._active_streams
        return snap

    async def _peer_snapshots(self, dep: str) -> dict:
        """Admission snapshots of every OTHER registered proxy (empty for
        a single-proxy fleet — the common case costs one cached registry
        lookup and no peer calls). Dead/restarting peers are skipped; the
        reconciled registry catches up when they rejoin."""
        loop = asyncio.get_event_loop()
        now = loop.time()
        ts, names = self._proxy_registry_cache
        if now - ts > 2.0:
            try:
                controller = ray_tpu_torch.get_actor(self.controller_name)
                ref = controller.list_proxies.remote()
                reg = await loop.run_in_executor(
                    None, lambda r=ref: ray_tpu_torch.get(r, timeout=2))
                names = sorted(reg or {})
            except Exception:
                names = []
            self._proxy_registry_cache = (now, names)
        peers: dict = {}
        for name in names:
            if name == self.proxy_id:
                continue
            try:
                h = ray_tpu_torch.get_actor(name)
                ref = h.admission_snapshot.remote(dep)
                snap = await loop.run_in_executor(
                    None, lambda r=ref: ray_tpu_torch.get(r, timeout=2))
                if isinstance(snap, dict):
                    peers[name] = snap
            except Exception:
                continue
        return peers

    def _mint_request(self) -> None:
        try:
            from ray_tpu_torch.util import metrics as _m

            _m.SERVE_PROXY_REQS.inc(1, tags={"proxy": self.proxy_id})
        except Exception:
            pass

    def _mint_stream(self, delta: int) -> None:
        self._active_streams = max(0, self._active_streams + delta)
        try:
            from ray_tpu_torch.util import metrics as _m

            if delta > 0:
                _m.SERVE_PROXY_STREAMS.inc(1, tags={"proxy": self.proxy_id})
            _m.SERVE_PROXY_ACTIVE.set(float(self._active_streams),
                                      tags={"proxy": self.proxy_id})
        except Exception:
            pass

    def _bucket_shed(self, prefix: str, dep: str):
        """Front-door rate limit: returns a 429 response when the route's
        token bucket is dry, None to admit. Off unless RT_SERVE_RPS > 0."""
        rate = float(CONFIG.serve_rps)
        if rate <= 0:
            return None
        burst = max(1, int(CONFIG.serve_burst))
        now = time.monotonic()
        b = self._buckets.get(prefix)
        if b is None or b.rate != rate or b.burst != burst:
            b = self._buckets[prefix] = _TokenBucket(rate, burst, now)
        wait = b.take(now)
        if wait <= 0.0:
            return None
        try:
            # Rides the router's shed accounting so /v1/stats shed_total
            # and the rt_serve_shed metric cover front-door rejections too.
            get_router(self.controller_name, dep).record_shed("rate_limit")
        except Exception:
            pass
        from ray_tpu_torch.exceptions import BackPressureError

        return self._shed_response(BackPressureError(
            f"route {prefix!r} over its rate limit "
            f"({rate:g} req/s, burst {burst})",
            deployment=dep, reason="rate_limit", retry_after_s=wait))

    @staticmethod
    def _shed_response(e):
        """Map a BackPressureError to HTTP: 429 for loads the client can
        back off from (rate limit, full queue, busy replicas), 503 for a
        request that already burned its queue deadline. Both carry
        Retry-After so well-behaved clients pace themselves."""
        from aiohttp import web

        status = 503 if e.reason == "deadline" else 429
        retry_after = max(1, math.ceil(float(e.retry_after_s or 1.0)))
        return web.json_response(
            {"error": {"type": "BackPressureError", "reason": e.reason,
                       "deployment": e.deployment, "queued": e.queued,
                       "retry_after_s": e.retry_after_s,
                       "message": str(e)}},
            status=status, headers={"Retry-After": str(retry_after)})

    @staticmethod
    def _death_response(dep: str, replica_id, e):
        """Replica died mid-request and the retry budget is spent: 503
        (retriable — the controller is already restarting it), naming the
        replica and where its fate is recorded. Distinct from the shed
        429s: THIS request was admitted and lost, not rejected."""
        from aiohttp import web

        entity = replica_id or dep
        return web.json_response(
            {"error": {"type": type(e).__name__, "deployment": dep,
                       "replica": replica_id, "retriable": True,
                       "detail": str(e) or repr(e),
                       "events": f"ray-tpu events --entity {entity}"}},
            status=503, headers={"Retry-After": "1"})

    @staticmethod
    def _stream_error_payload(dep: str, replica_id, e) -> dict:
        """Structured SSE error event: once streaming has begun the status
        line is gone, so mid-stream replica death is reported in-band —
        typed, naming the replica and its event-plane entity — instead of
        a bare repr the client can only string-match."""
        from ray_tpu_torch.dag.push_stream import StreamSevered
        from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError

        err = {"type": type(e).__name__, "deployment": dep,
               "detail": str(e) or repr(e)}
        if isinstance(e, (ActorDiedError, WorkerCrashedError,
                          StreamSevered)):
            # A severed/corrupted push-stream link is attributed like a
            # replica death: the client learns WHICH replica's stream was
            # lost and where its fate is recorded, and may retry.
            entity = replica_id or dep
            err["replica"] = replica_id
            err["retriable"] = True
            err["events"] = f"ray-tpu events --entity {entity}"
        return {"error": err}

    async def _handle(self, request):
        from aiohttp import web

        m = self._match(request.path)
        if m is None:
            return web.Response(status=404, text="no deployment matches path")
        _prefix, dep = m
        self._mint_request()
        admission = bool(CONFIG.serve_admission)
        # Stats requests bypass both the token bucket and the admission
        # queue: observability must stay readable exactly when the
        # deployment is saturated, or overloads can't be diagnosed.
        is_stats = (request.method == "GET"
                    and request.path.rstrip("/").endswith("/stats"))
        if admission and not is_stats:
            shed = self._bucket_shed(_prefix, dep)
            if shed is not None:
                return shed
        body = await request.read()
        # Trace root: an ingress request roots its own trace (head-based
        # RT_TRACE_SAMPLE; slow unsampled requests escalate via
        # RT_TRACE_SLOW_S in end_request). The context set here is copied
        # into the assign executor hop below, so the actor-call submit —
        # and everything downstream of the replica — chains under it.
        trh = _tracing.start_request(f"http {request.method} {request.path}")
        headers = dict(request.headers)
        tid = _tracing.request_trace_id(trh)
        if tid is not None:
            # Propagated in-band for deployments that want to tag logs /
            # downstream calls with the request's trace.
            headers["rt-trace-id"] = tid
        req = Request(method=request.method, path=request.path,
                      query=dict(request.query),
                      headers=headers, body=body)
        router = get_router(self.controller_name, dep)
        loop = asyncio.get_event_loop()
        # reference multiplex header: routes to a replica with the model hot.
        model_id = request.headers.get("serve_multiplexed_model_id", "")

        # Streaming requests (OpenAI-style {"stream": true} body or SSE
        # Accept header) ride the replica's streaming generator and are
        # written out as server-sent events as items arrive (reference
        # proxy.py streaming ASGI responses).
        want_stream = "text/event-stream" in request.headers.get("Accept", "")
        if not want_stream and body[:1] == b"{":
            try:
                want_stream = bool(json.loads(body).get("stream"))
            except Exception:
                want_stream = False
        if want_stream:
            try:
                return await self._handle_streaming(request, req, router,
                                                    model_id, loop)
            finally:
                _tracing.end_request(
                    trh, f"http {request.method} {request.path}",
                    {"deployment": dep, "stream": True})

        cancel = threading.Event() if admission else None
        meta: dict = {}

        async def _once():
            # Legacy path: assign only blocks when there are no replicas
            # (rare), so the default executor thread is held for
            # microseconds, not the request duration; the result await
            # costs no thread at all. Admission path: assign can park in
            # the bounded queue up to the deadline, so it rides the
            # dedicated pool and honors the client-disconnect cancel.
            # run_in_executor does NOT propagate contextvars (the trace
            # context, like the multiplexed id in replica.py): copy it in.
            pctx = contextvars.copy_context()
            if admission:
                fut = loop.run_in_executor(
                    self._pool(), lambda: pctx.run(
                        router.assign, "__call__", (req,), {},
                        multiplexed_model_id=model_id,
                        cancel=cancel, meta=meta,
                        bypass_queue=is_stats))
                try:
                    ref = await fut
                except asyncio.CancelledError:
                    # Client gone while (possibly) queued: release the
                    # queue slot; the parked thread notices within its
                    # 100ms poll. Consume the future's eventual
                    # QueueCancelled so it isn't logged as unretrieved.
                    cancel.set()
                    fut.add_done_callback(
                        lambda f: f.cancelled() or f.exception())
                    raise
            else:
                ref = await loop.run_in_executor(
                    None, lambda: pctx.run(
                        router.assign, "__call__", (req,), {},
                        multiplexed_model_id=model_id))
            return await self._resolver.submit(ref)

        try:
            if not admission:
                try:
                    result = await _once()
                except Exception as e:
                    from ray_tpu_torch.exceptions import (
                        ActorDiedError,
                        WorkerCrashedError,
                    )

                    if isinstance(e, (ActorDiedError, WorkerCrashedError)):
                        # replica died mid-request: retry once on a survivor
                        try:
                            result = await _once()
                            return self._to_response(result)
                        except Exception as e2:  # noqa: F841
                            e = e2
                    logger.error("serve proxy error: %r", e)
                    return web.Response(status=500, text=repr(e))
                return self._to_response(result)
            from ray_tpu_torch.exceptions import (
                ActorDiedError,
                BackPressureError,
                WorkerCrashedError,
            )

            try:
                retries = max(0, int(CONFIG.serve_retries))
                for attempt in range(retries + 1):
                    try:
                        result = await _once()
                        break
                    except (ActorDiedError, WorkerCrashedError):
                        # Replica died mid-request: jittered backoff, then
                        # re-admit against the survivors — until the
                        # per-request retry budget (RT_SERVE_RETRIES) runs
                        # out.
                        if attempt >= retries:
                            raise
                        await asyncio.sleep(_retry_pause_s(attempt))
                    except Exception as e:
                        # A replica-side concurrency-cap rejection (a race
                        # between routers) is retriable; real application
                        # errors are not. It crosses the wire wrapped in
                        # TaskError — unwrap so exhaustion still maps to
                        # 429, not 500.
                        if not _is_replica_busy(e):
                            raise
                        if attempt >= retries:
                            # Replica-raised: this router never counted it
                            # (its own slot view was free), so account the
                            # shed here before surfacing the 429.
                            router.record_shed("replica_busy")
                            cause = getattr(e, "cause", None)
                            raise cause if isinstance(
                                cause, BackPressureError) else e
                        await asyncio.sleep(_retry_pause_s(attempt))
                if is_stats and isinstance(result, dict):
                    serve_stats = router.admission_stats()
                    if serve_stats is not None:
                        result = dict(result)
                        peers = await self._peer_snapshots(dep)
                        if peers:
                            # Multi-proxy fleet: active-slot/queue counts
                            # are summed ACROSS proxies (each runs its own
                            # admission queue against the shared budgets)
                            # with a per-proxy breakdown alongside. A
                            # single-proxy response stays byte-identical —
                            # no peers, no extra keys.
                            import os as _os

                            agg = dict(serve_stats)
                            per = {self.proxy_id: dict(
                                serve_stats, pid=_os.getpid(),
                                active_streams=self._active_streams)}
                            for pname, snap in peers.items():
                                agg["queued"] += int(snap.get("queued", 0))
                                agg["shed_total"] += int(
                                    snap.get("shed_total", 0))
                                per[pname] = snap
                            result["serve"] = agg
                            result["serve_proxies"] = per
                        else:
                            result["serve"] = serve_stats
                return self._to_response(result)
            except BackPressureError as e:
                return self._shed_response(e)
            except (ActorDiedError, WorkerCrashedError) as e:
                logger.error("serve proxy error (replica death): %r", e)
                return self._death_response(dep, meta.get("replica_id"), e)
            except QueueCancelled:
                # Client disconnected while queued; the handler task is
                # normally cancelled before this surfaces — treat alike.
                raise asyncio.CancelledError()
            except Exception as e:
                logger.error("serve proxy error: %r", e)
                return web.Response(status=500, text=repr(e))
        finally:
            _tracing.end_request(trh, f"http {request.method} {request.path}",
                                 {"deployment": dep})

    @staticmethod
    def _sse_chunk(item) -> bytes:
        if isinstance(item, bytes):
            data = item.decode("utf-8", "replace")
        elif isinstance(item, str):
            data = item
        else:
            data = json.dumps(item)
        return f"data: {data}\n\n".encode()

    async def _stream_from_ring(self, resp, ring, gen, loop):
        """Token-ring reply path (README "Serving hot loop"): drain item
        batches from the transport — ONE reader wakeup and ONE socket
        flush per burst, however many tokens it carries — until the
        producer's end/err record. `ring` is either a shm StreamRing
        (same-host) or a PushStreamReader (cross-host); both speak the
        same read_batch contract. Replica death is detected via the
        stream task's completion ref, so a dead producer surfaces an
        attributed error within the resolver's poll cadence instead of
        hanging the SSE."""
        from ray_tpu_torch.dag.push_stream import StreamSevered
        from ray_tpu_torch.dag.stream import RingClosed

        cfut = self._resolver.submit(gen.completed())
        # Consume the exception if the response path never does (a stream
        # that ended via its "end" record before the death raced in).
        cfut.add_done_callback(
            lambda f: f.cancelled() or f.exception())
        completed_grace = False
        while True:
            try:
                batch = await loop.run_in_executor(
                    self._stream_pool,
                    lambda: ring.read_batch(timeout=0.25))
            except TimeoutError:
                if cfut.done():
                    exc = cfut.exception()
                    if exc is not None:
                        raise exc  # replica died mid-stream: attributed
                    if completed_grace:
                        # Task finished, ring drained, no end record (the
                        # producer was interrupted between its last item
                        # and the end marker): finish cleanly.
                        break
                    completed_grace = True
                continue
            except RingClosed:
                break
            except StreamSevered as sev:
                # The push link dropped (or lost a frame) mid-stream. If
                # the replica itself died, the completion ref knows within
                # its poll cadence — prefer that attribution; otherwise
                # surface the sever itself (also attributed, retriable).
                for _ in range(20):
                    if cfut.done():
                        exc = cfut.exception()
                        if exc is not None:
                            raise exc
                        break
                    await asyncio.sleep(0.25)
                try:
                    from ray_tpu_torch._private.events import emit_event

                    emit_event(
                        "serve_stream_sever",
                        f"push-stream severed mid-SSE: {sev}",
                        entity=(self.proxy_id,))
                except Exception:
                    pass
                raise
            buf = bytearray()
            done = False
            for rec in batch:
                kind = rec[0]
                if kind == "item":
                    buf += self._sse_chunk(rec[1])
                elif kind == "end":
                    done = True
                elif kind == "err":
                    buf += self._sse_chunk({"error": rec[1]})
                    done = True
            if buf:
                await resp.write(bytes(buf))  # coalesced: one flush/burst
            if done:
                break
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()

    async def _handle_streaming(self, request, req, router, model_id, loop):
        """SSE response: one `data:` event per streamed item, then [DONE].
        With the token ring armed (RT_TOKEN_RING, default on) items ride a
        per-request shm StreamRing from the replica — one host hop per
        item BATCH — and multi-item arrivals coalesce into single socket
        flushes; RT_TOKEN_RING=0 keeps the classic one-ObjectRef-per-item
        reply path byte-identically."""
        from aiohttp import web

        # The stream's set-up up to the replica's call (ring, push-stream
        # hub, router assign) as one span of the request: it is most of a
        # short request's time outside the replica.
        assign_span = _tracing.open_root("serve.stream_assign", "serve")
        ring = None
        ring_spec = None
        reader = None
        if CONFIG.token_ring and (
                loop.time() - self._ring_nak.get(router.deployment, -1e9)
                > 60.0):
            try:
                import uuid

                from ray_tpu_torch.dag.stream import StreamRing

                # The pid in the name makes the segment attributable: a
                # proxy that dies mid-stream (SIGKILL) can't run its
                # unlink finally, so the next proxy to start sweeps ring
                # files whose creator pid is gone (_sweep_dead_rings).
                sid = f"sse_{os.getpid()}_{uuid.uuid4().hex[:12]}"
                ring = StreamRing(sid, int(CONFIG.token_ring_bytes))
                ring_spec = ring.spec()
            except Exception as e:
                logger.debug("token ring unavailable (%r): classic path", e)
                ring = None
                ring_spec = None
            if ring is not None and CONFIG.stream_push:
                # Offer the push-stream transport alongside the shm ring
                # (README "Cross-host streaming & multi-proxy"): a replica
                # that can't mmap our /dev/shm segment — it lives on
                # another host — dials back into this proxy's hub and
                # answers the handshake with "push" instead of "nak".
                try:
                    window = int(CONFIG.stream_window_bytes)
                    hub = await self._ensure_hub()
                    reader = hub.open(sid, window)
                    ring_spec["push"] = hub.spec(sid, window)
                except Exception as e:
                    logger.debug("push-stream hub unavailable (%r)", e)
                    reader = None
        admission = bool(CONFIG.serve_admission)
        cancel = threading.Event() if admission else None
        meta: dict = {}
        try:
            pctx = contextvars.copy_context()  # carry the trace context
            if admission:
                gen = await self._assign_stream(router, req, model_id,
                                                ring_spec, loop, pctx,
                                                cancel, meta)
            else:
                gen = await loop.run_in_executor(
                    None, lambda: pctx.run(
                        router.assign, "__call__", (req,), {},
                        multiplexed_model_id=model_id, streaming=True,
                        stream_ring=ring_spec))
        except asyncio.CancelledError:
            if ring is not None:
                ring.close(unlink=True)
            if reader is not None:
                reader.close()
            raise
        except Exception as e:
            if ring is not None:
                ring.close(unlink=True)
            if reader is not None:
                reader.close()
            if admission:
                from ray_tpu_torch.exceptions import (
                    ActorDiedError,
                    BackPressureError,
                    WorkerCrashedError,
                )

                # The status line is still ours pre-stream: sheds and
                # replica death map to typed 429/503 rather than SSE.
                if isinstance(e, BackPressureError):
                    return self._shed_response(e)
                if isinstance(e, (ActorDiedError, WorkerCrashedError)):
                    logger.error(
                        "serve proxy stream error (replica death): %r", e)
                    return self._death_response(
                        router.deployment, meta.get("replica_id"), e)
            logger.error("serve proxy stream assign error: %r", e)
            return web.Response(status=500, text=repr(e))
        finally:
            _tracing.close_root(assign_span)
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive"})
        await resp.prepare(request)
        self._pool()
        self._mint_stream(+1)
        it = iter(gen)
        sentinel = object()
        try:
            carry = None  # a first item the ring handshake pass consumed
            if ring is not None:
                # The replica's first generator item is the ring handshake
                # (ok = shm ring / push = rpc push-stream / nak). Anything
                # else means a producer that ignored the ring ask — fall
                # back and emit that item normally.
                ref = await loop.run_in_executor(
                    self._stream_pool, lambda: next(it, sentinel))
                first = (sentinel if ref is sentinel
                         else await self._resolver.submit(ref))
                if isinstance(first, dict) and "__rt_ring__" in first:
                    if first["__rt_ring__"] == "ok":
                        await self._stream_from_ring(resp, ring, gen, loop)
                        return resp
                    if first["__rt_ring__"] == "push" and reader is not None:
                        # Remote replica: same drain loop, fed by the hub
                        # reader (read_batch-compatible) instead of shm.
                        await self._stream_from_ring(resp, reader, gen,
                                                     loop)
                        return resp
                    self._ring_nak[router.deployment] = loop.time()
                elif first is not sentinel:
                    carry = first
            while True:
                if carry is not None:
                    item, carry = carry, None
                else:
                    # next() blocks until the replica reports the next
                    # item; keep the proxy loop free while waiting.
                    ref = await loop.run_in_executor(
                        self._stream_pool, lambda: next(it, sentinel))
                    if ref is sentinel:
                        break
                    item = await self._resolver.submit(ref)
                await resp.write(self._sse_chunk(item))
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
        except Exception as e:
            # Client disconnects raise from resp.write: the tail writes
            # must not raise uncaught (they'd leak the stream below).
            logger.debug("serve proxy stream ended early: %r", e)
            try:
                if admission:
                    payload = self._stream_error_payload(
                        router.deployment, meta.get("replica_id"), e)
                else:
                    payload = {"error": repr(e)}
                await resp.write(
                    f"data: {json.dumps(payload)}\n\n".encode())
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
            except Exception:
                pass
        finally:
            # Drop the generator NOW: its finalizer sends gen_close to the
            # replica, whose streaming wrapper closes the user iterator,
            # which releases the engine slot — without this, an abandoned
            # LLM stream keeps decoding to max_tokens for nobody.
            del it
            del gen
            if ring is not None:
                ring.close(unlink=True)
            if reader is not None:
                reader.close()
            self._mint_stream(-1)
        return resp

    async def _assign_stream(self, router, req, model_id, ring_spec, loop,
                             pctx, cancel, meta):
        """Admission-path streaming assign: rides the dedicated pool (it
        may park in the bounded queue up to the deadline), frees the queue
        slot if the client disconnects while waiting, and retries
        replica-busy races under the RT_SERVE_RETRIES budget."""
        retries = max(0, int(CONFIG.serve_retries))
        for attempt in range(retries + 1):
            fut = loop.run_in_executor(
                self._pool(), lambda: pctx.run(
                    router.assign, "__call__", (req,), {},
                    multiplexed_model_id=model_id, streaming=True,
                    stream_ring=ring_spec, cancel=cancel, meta=meta))
            try:
                return await fut
            except asyncio.CancelledError:
                cancel.set()
                fut.add_done_callback(
                    lambda f: f.cancelled() or f.exception())
                raise
            except Exception as e:
                from ray_tpu_torch.exceptions import (
                    ActorDiedError,
                    WorkerCrashedError,
                )

                retriable = (isinstance(e, (ActorDiedError,
                                            WorkerCrashedError))
                             or _is_replica_busy(e))
                if not retriable or attempt >= retries:
                    raise
                await asyncio.sleep(_retry_pause_s(attempt))

    def _to_response(self, result):
        from aiohttp import web

        if isinstance(result, (dict, list)):
            return web.json_response(result)
        if isinstance(result, bytes):
            return web.Response(body=result,
                                content_type="application/octet-stream")
        if isinstance(result, web.Response):
            return result
        return web.Response(text=str(result))
