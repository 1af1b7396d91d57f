"""One import point for grpc, deferred until the first attribute access.

The counterpart of ``gpumounter_tpu/utils/lazy_grpc.py``. The mount path
(``worker/mounter.py``, ``nsutil/``, whose helper is the compiled
``gpumounter-nsexec``, exec'd) and ``master/app.py`` need
no gRPC, so they import without it, and a process that runs only them
never loads grpcio. No module of the package
imports grpc at its top; each does

    from gpumounter_tpu_torch.utils.lazy_grpc import grpc

and the real module loads when a channel or server is built. On a host
without grpcio that first use raises ``ModuleNotFoundError`` naming grpcio;
nothing catches it.
"""

from __future__ import annotations

import importlib
from typing import Any


class _LazyGrpc:
    """Attribute-forwarding proxy; imports grpc once, on demand."""

    _module = None

    def _load(self):
        if _LazyGrpc._module is None:
            try:
                _LazyGrpc._module = importlib.import_module("grpc")
            except ModuleNotFoundError as exc:
                if exc.name != "grpc":
                    raise
                raise ModuleNotFoundError(
                    "the gRPC transport needs the grpcio package (import grpc), which "
                    "this host does not have", name="grpc") from exc
        return _LazyGrpc._module

    def __getattr__(self, name: str) -> Any:
        return getattr(self._load(), name)


grpc = _LazyGrpc()

