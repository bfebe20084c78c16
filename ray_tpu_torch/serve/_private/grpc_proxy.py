"""gRPC ingress for Serve.

Parity target: reference python/ray/serve/_private/proxy.py:530 (gRPCProxy
— a per-node gRPC server routing RPCs to deployment replicas, sharing the
HTTP proxy's route table and router machinery, including server-streaming
responses). The reference serves user-registered proto services; here a
GENERIC handler serves every deployment without protoc: the fully-
qualified method name carries the route —

    /ray_tpu_torch.serve.<deployment>/<method>        unary -> unary
    /ray_tpu_torch.serve.<deployment>/<method>Stream  unary -> server stream

Request/response payloads are raw bytes: callers send whatever the
deployment expects (JSON, pickle, protobuf-encoded messages of their own
schema); the deployment's return value is sent back pickled unless it is
already bytes. Streaming methods ride the same core streaming-generator
transport as the HTTP SSE path.

Counterpart: ray_tpu/serve/_private/grpc_proxy.py (copied).
"""

from __future__ import annotations

import logging
import pickle
from concurrent import futures as _futures
from typing import Optional

logger = logging.getLogger(__name__)

_PREFIX = "ray_tpu_torch.serve."


class _GrpcRequest:
    """Request view handed to deployments for gRPC ingress (the role the
    reference fills with the user proto message + grpc_context)."""

    def __init__(self, method: str, body: bytes, metadata: dict):
        self.method = "GRPC"
        self.grpc_method = method
        self.body = body
        self.headers = metadata
        self.path = method
        self.query = {}

    def json(self):
        import json as _json

        return _json.loads(self.body or b"null")

    def __repr__(self):
        return f"GrpcRequest({self.grpc_method})"


def _encode(value) -> bytes:
    if isinstance(value, bytes):
        return value
    return pickle.dumps(value)


class GrpcIngress:
    """Generic gRPC server bound inside the proxy actor. Routes by method
    name; deployment lookup + replica routing reuse the proxy's router."""

    def __init__(self, proxy, host: str, port: int):
        import grpc

        self._proxy = proxy
        self._grpc = grpc
        self._server = grpc.server(
            _futures.ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="rt-grpc"),
            options=[("grpc.so_reuseport", 0)])
        self._server.add_generic_rpc_handlers((_Handler(self),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            # grpc returns 0 on bind failure instead of raising; a silently
            # dead ingress would report "enabled" while refusing everything.
            raise OSError(f"gRPC ingress could not bind {host}:{port}")
        self._server.start()

    def stop(self):
        self._server.stop(grace=1.0)

    # ------------------------------------------------------------- routing
    def _route(self, full_method: str):
        """'/ray_tpu_torch.serve.<dep>/<method>' -> (deployment, method, stream)."""
        try:
            service, method = full_method.lstrip("/").split("/", 1)
        except ValueError:
            return None
        if not service.startswith(_PREFIX):
            return None
        dep = service[len(_PREFIX):]
        stream = method.endswith("Stream")
        if stream:
            method = method[:-len("Stream")] or "__call__"
        return dep, method, stream

    def _call_unary(self, dep: str, method: str, request: "_GrpcRequest"):
        from ray_tpu_torch.serve._private.router import get_router

        import ray_tpu_torch

        router = get_router(self._proxy.controller_name, dep)
        ref = router.assign(method, (request,), {})
        return _encode(ray_tpu_torch.get(ref, timeout=60))

    def _call_stream(self, dep: str, method: str, request: "_GrpcRequest"):
        from ray_tpu_torch.serve._private.router import get_router

        import ray_tpu_torch

        router = get_router(self._proxy.controller_name, dep)
        gen = router.assign(method, (request,), {}, streaming=True)
        for ref in gen:
            yield _encode(ray_tpu_torch.get(ref, timeout=60))


class _Handler:
    """grpc.GenericRpcHandler serving every /ray_tpu_torch.serve.* method."""

    def __init__(self, ingress: GrpcIngress):
        self._ingress = ingress
        import grpc

        self._grpc = grpc

    def service(self, handler_call_details):
        grpc = self._grpc
        routed = self._ingress._route(handler_call_details.method)
        if routed is None:
            return None
        dep, method, stream = routed
        if dep not in set(self._ingress._proxy.routes.values()):
            # Unknown deployment: answer UNIMPLEMENTED immediately from the
            # proxy's route table. Falling through to the router would
            # block the handler thread for the full replica wait AND cache
            # a Router (two live threads) per bogus name — a trivial
            # resource-exhaustion vector on a public port.
            return None
        md = dict(handler_call_details.invocation_metadata or ())

        ident = lambda b: b  # noqa: E731 — payloads are raw bytes

        if stream:
            def handle_stream(request_bytes, context):
                req = _GrpcRequest(handler_call_details.method,
                                   request_bytes, md)
                try:
                    yield from self._ingress._call_stream(dep, method, req)
                except Exception as e:
                    from ray_tpu_torch.exceptions import BackPressureError

                    if isinstance(e, BackPressureError):
                        # Shed by admission control: RESOURCE_EXHAUSTED is
                        # the canonical gRPC back-pressure code (clients
                        # back off), not INTERNAL (clients report a bug).
                        context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
                    logger.error("grpc stream %s failed: %r",
                                 handler_call_details.method, e)
                    context.abort(grpc.StatusCode.INTERNAL, repr(e))

            return grpc.unary_stream_rpc_method_handler(
                handle_stream, request_deserializer=ident,
                response_serializer=ident)

        def handle_unary(request_bytes, context):
            req = _GrpcRequest(handler_call_details.method, request_bytes, md)
            try:
                return self._ingress._call_unary(dep, method, req)
            except Exception as e:
                from ray_tpu_torch.exceptions import BackPressureError

                if isinstance(e, BackPressureError):
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
                logger.error("grpc %s failed: %r",
                             handler_call_details.method, e)
                context.abort(grpc.StatusCode.INTERNAL, repr(e))

        return grpc.unary_unary_rpc_method_handler(
            handle_unary, request_deserializer=ident,
            response_serializer=ident)
