"""The master's shared, bounded fan-out core.

The counterpart of ``gpumounter_tpu/utils/fanout.py``. One process-wide
executor serves every path of the master that fans out to workers (the
slice's per-host mounts and removes, the batch's node groups):

  * its width is the host's (``fanout_width``, 0 = auto), shared by every
    pass instead of a pool of its own per pass;
  * a pass may cap its own slots (``limit``): the batch holds at most
    ``bulk_node_fanout`` node groups at once. The reference's per-shard
    budgets inside one pass, ``submit`` and ``fanout_shard_budget`` come
    with 7h, whose owner shards are the first caller that needs them;
  * results in item order, and the first error re-raised only after the
    whole pass has drained, as ``pool.map`` would;
  * a task that fans out itself runs its items on transient threads instead
    of submitting to the pool it runs on, so nested passes cannot starve
    each other into a deadlock.

Its series count tasks by the bounded kind vocabulary and the tasks in
flight; node names never become labels.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent import futures

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.metrics import REGISTRY

FANOUT_TASKS = REGISTRY.counter(
    "tpumounter_fanout_tasks_total",
    "tasks executed on the shared fan-out core, by kind")
FANOUT_INFLIGHT = REGISTRY.gauge(
    "tpumounter_fanout_inflight",
    "tasks currently running on the shared fan-out core")
FANOUT_SHARD_WAITS = REGISTRY.counter(
    "tpumounter_fanout_shard_waits_total",
    "task submissions parked behind a per-shard concurrency budget")


def _auto_width() -> int:
    return max(32, 4 * (os.cpu_count() or 8))


class FanoutCore:
    """One bounded executor shared by every fan-out of the master."""

    def __init__(self, cfg=None):
        cfg = cfg or Config()
        self.width = int(cfg.fanout_width) or _auto_width()
        self._pool = futures.ThreadPoolExecutor(max_workers=self.width,
                                                thread_name_prefix="fanout-core")
        self._in_core = threading.local()

    def _call(self, fn, item, kind: str):
        self._in_core.active = True
        FANOUT_INFLIGHT.inc()
        try:
            return fn(item)
        finally:
            FANOUT_INFLIGHT.dec()
            FANOUT_TASKS.inc(kind=kind)
            self._in_core.active = False

    def _nested(self) -> bool:
        return bool(getattr(self._in_core, "active", False))

    def run(self, items, fn, *, kind: str = "task", limit: int | None = None) -> list:
        """fn(item) for every item; the results in item order.

        With `limit`, the pass holds at most that many slots at a time and
        the rest of its items wait (counted on FANOUT_SHARD_WAITS, the
        reference's series for a budget's waits). The first exception
        re-raises after every item has finished; a caller that wants each
        item's failure catches inside fn."""
        items = list(items)
        if not items:
            return []
        cap = max(1, int(limit)) if limit else len(items)
        if self._nested():
            return self._run_transient(items, fn, kind, min(cap, self.width))

        results: list = [None] * len(items)
        first_error: BaseException | None = None
        inflight: dict[futures.Future, int] = {}
        pending = deque(range(len(items)))

        def start(i: int) -> None:
            inflight[self._pool.submit(self._call, fn, items[i], kind)] = i

        while pending and len(inflight) < cap:
            start(pending.popleft())
        if pending:
            FANOUT_SHARD_WAITS.inc(len(pending))
        while inflight:
            done, _ = futures.wait(list(inflight), return_when=futures.FIRST_COMPLETED)
            for fut in done:
                i = inflight.pop(fut)
                try:
                    results[i] = fut.result()
                except BaseException as exc:  # noqa: BLE001 — drain the pass first
                    if first_error is None:
                        first_error = exc
                if pending:
                    start(pending.popleft())
        if first_error is not None:
            raise first_error
        return results

    def _run_transient(self, items, fn, kind, width: int) -> list:
        """A nested pass: waves of `width` transient threads; never the pool
        the caller runs on."""
        results: list = [None] * len(items)
        errors: list = [None] * len(items)

        def _one(i: int) -> None:
            try:
                results[i] = self._call(fn, items[i], kind)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors[i] = exc

        for base in range(0, len(items), width):
            wave = [threading.Thread(target=_one, args=(i,), daemon=True, name="fanout-nested")
                    for i in range(base, min(base + width, len(items)))]
            for th in wave:
                th.start()
            for th in wave:
                th.join()
        for exc in errors:
            if exc is not None:
                raise exc
        return results

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


_CORE: FanoutCore | None = None
_CORE_MU = OrderedLock("fanout.core")


def get_core(cfg=None) -> FanoutCore:
    """The process's core, sized by its first caller's config."""
    global _CORE
    with _CORE_MU:
        if _CORE is None:
            _CORE = FanoutCore(cfg)
        return _CORE


def reset_core() -> None:
    """Drop the core, so that the next ``get_core`` sizes one from its
    caller's config (tests, and a check that wants its own width)."""
    global _CORE
    with _CORE_MU:
        if _CORE is not None:
            _CORE.shutdown()
        _CORE = None
