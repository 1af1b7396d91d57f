"""Typed Kubernetes API errors, and the rule that sorts a failure into an
answer or an outage.

The counterpart of ``gpumounter_tpu/k8s/errors.py``:

    ApiError                 any failure of the API layer (carries .status)
      NotFoundError   404    the API answered: the object is gone
      ConflictError   409    the API answered: it exists, or a CAS lost
      GoneError       410    the API answered: the watch's version expired
      ServerError     5xx    the API server failed on its own (retriable)
        ApiTimeoutError 504  a gateway timeout, or a deadline that expired
        PartitionError  503  the API server cannot be reached: a refused or
                             reset connection, a socket timeout, the fake's
                             ``set_partitioned``

A 4xx is an answer and proves the server alive; a ``ServerError``, a
transport failure (``classify_exception`` turns one into a typed error) and
an ``ApiError`` of status 0 count toward ApiHealth's degraded and down
(``is_outage``). A local ``OSError`` (a token file that cannot be read) is
neither: a kubelet rotating the token must not park the control plane.
"""

from __future__ import annotations

import socket


class ApiError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"kubernetes api error {status}: {message}")
        self.status = status
        self.message = message


class NotFoundError(ApiError):
    """404: the API answered, and the object is gone."""

    def __init__(self, message: str = ""):
        super().__init__(404, message)


class ConflictError(ApiError):
    """409: the object exists already, or a version conflict."""

    def __init__(self, message: str = ""):
        super().__init__(409, message)


class GoneError(ApiError):
    """410: the watch's resourceVersion fell out of the API server's
    window; the watcher must LIST again."""

    def __init__(self, message: str = ""):
        super().__init__(410, message)


class ServerError(ApiError):
    """5xx: the API server answered with a failure of its own. Safe to
    retry, and evidence toward a degraded or down verdict."""


class ApiTimeoutError(ServerError):
    """504, or a client-side deadline that expired in flight."""

    def __init__(self, message: str = "", status: int = 504):
        super().__init__(status, message)


class PartitionError(ServerError):
    """The API server is unreachable. Status 503, so that every handler of
    an ApiError of 5xx still fires."""

    def __init__(self, message: str = ""):
        super().__init__(503, message)


def raise_for(status: int, body: str) -> None:
    """An HTTP error status as the typed error."""
    if status == 404:
        raise NotFoundError(body)
    if status == 409:
        raise ConflictError(body)
    if status == 410:
        raise GoneError(body)
    if status == 504:
        raise ApiTimeoutError(body)
    if status >= 500:
        raise ServerError(status, body)
    raise ApiError(status, body)


#: transport failures: the API server could not be reached or was lost
_TRANSPORT_EXCS = (ConnectionError, BrokenPipeError, socket.timeout, TimeoutError,
                   socket.gaierror, OSError)

#: OSErrors that are local (a file, a path, a process), never evidence
#: that the API server is unreachable
_LOCAL_OS_EXCS = (FileNotFoundError, PermissionError, NotADirectoryError, IsADirectoryError,
                  FileExistsError, ProcessLookupError)


def _is_transport(exc: Exception) -> bool:
    return isinstance(exc, _TRANSPORT_EXCS) and not isinstance(exc, _LOCAL_OS_EXCS)


def _from_http_module(exc: Exception) -> bool:
    # http.client's connection-state errors share no base with ConnectionError
    return type(exc).__module__.startswith(("http.", "ssl"))


def classify_exception(exc: Exception) -> ApiError:
    """Any exception of the client layer as a typed error (a typed one
    passes through): a timeout ApiTimeoutError, a transport failure or one
    of http.client / ssl PartitionError, anything else ApiError(0)."""
    if isinstance(exc, ApiError):
        return exc
    if isinstance(exc, (socket.timeout, TimeoutError)):
        return ApiTimeoutError(str(exc) or type(exc).__name__)
    if _is_transport(exc) or _from_http_module(exc):
        return PartitionError(f"{type(exc).__name__}: {exc}")
    return ApiError(0, f"{type(exc).__name__}: {exc}")


def is_retriable(exc: Exception) -> bool:
    """May the same request succeed when sent again? A conflict (a merge
    patch re-applies safely), a 5xx and a transport failure; never a 404 or
    another 4xx."""
    if isinstance(exc, (ConflictError, ServerError)):
        return True
    if isinstance(exc, ApiError):
        return exc.status >= 500
    return _is_transport(exc)


def is_outage(exc: Exception) -> bool:
    """Is this failure evidence that the API server is degraded or
    unreachable, rather than a live server's 4xx answer? ApiHealth's rule."""
    if isinstance(exc, ServerError):
        return True
    if isinstance(exc, ApiError):
        return exc.status >= 500 or exc.status == 0
    return _is_transport(exc) or _from_http_module(exc)
