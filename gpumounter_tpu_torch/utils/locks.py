"""Named locks.

The counterpart of ``gpumounter_tpu/utils/locks.py``'s ``OrderedLock``, kept
small: a ``threading.Lock`` that carries the name by which the lock-order
graph knows it. The recorder of observed nestings, which the chaos harness
checks, comes with that harness.
"""

from __future__ import annotations

import threading


class OrderedLock:
    """A named threading.Lock for the ``with lock:`` discipline."""

    def __init__(self, name: str):
        if not name:
            raise ValueError("OrderedLock needs a non-empty name")
        self.name = name
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._inner.acquire(blocking, timeout)

    def release(self) -> None:
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name!r}>"
