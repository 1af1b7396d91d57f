"""The standard gRPC health service (grpc.health.v1.Health/Check).

The counterpart of ``gpumounter_tpu/rpc/health.py:21-57``. The original
worker has no health surface; gRPC-aware probes expect this protocol. Its
messages ride the port's codec, with no grpcio-health-checking package.
"""

from __future__ import annotations

from gpumounter_tpu_torch.rpc.wire import Field, Message
from gpumounter_tpu_torch.utils.lazy_grpc import grpc

SERVICE = "grpc.health.v1.Health"

SERVING = 1
NOT_SERVING = 2
SERVICE_UNKNOWN = 3


class HealthCheckRequest(Message):
    FIELDS = [Field(1, "service", "string")]


class HealthCheckResponse(Message):
    FIELDS = [Field(1, "status", "enum")]


def add_health_service(server, known_services: set[str] | None = None) -> None:
    known = known_services or set()

    def check(request: HealthCheckRequest, context) -> HealthCheckResponse:
        if request.service and known and request.service not in known:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown service {request.service}")
        return HealthCheckResponse(status=SERVING)

    handler = grpc.method_handlers_generic_handler(
        SERVICE,
        {"Check": grpc.unary_unary_rpc_method_handler(
            check, request_deserializer=HealthCheckRequest.decode,
            response_serializer=lambda m: m.encode())})
    server.add_generic_rpc_handlers((handler,))


def check_health(address: str, service: str = "", timeout_s: float = 5.0) -> int:
    """Client side of Check; returns the status value."""
    with grpc.insecure_channel(address) as channel:
        stub = channel.unary_unary(f"/{SERVICE}/Check",
                                   request_serializer=lambda m: m.encode(),
                                   response_deserializer=HealthCheckResponse.decode)
        return stub(HealthCheckRequest(service=service), timeout=timeout_s).status
