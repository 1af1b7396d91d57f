"""Typed Kubernetes API errors.

The counterpart of ``gpumounter_tpu/k8s/errors.py``, with the types the
mount path, the REST client and the master raise and catch. Each carries the HTTP ``status``,
which is how ``torchside/_kube.py`` reads any API error.
"""

from __future__ import annotations


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
    """5xx: the API server answered with a failure of its own."""


def raise_for(status: int, body: str) -> None:
    """An HTTP error status as the typed error."""
    if status == 404:
        raise NotFoundError(body)
    if status == 409:
        raise ConflictError(body)
    if status == 410:
        raise GoneError(body)
    if status >= 500:
        raise ServerError(status, body)
    raise ApiError(status, body)
