"""Typed Kubernetes API errors.

The counterpart of ``gpumounter_tpu/k8s/errors.py``, with the types the
one-node mount path raises and catches. Each carries the HTTP ``status``,
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
