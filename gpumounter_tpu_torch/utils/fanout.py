"""The master's shared, bounded fan-out core.

The counterpart of ``gpumounter_tpu/utils/fanout.py``. One process-wide
executor serves every path of the master that fans out to workers (the
slice's per-host mounts and removes, the batch's node groups):

  * its width is the host's (``fanout_width``, 0 = auto), shared by every
    pass instead of a pool of its own per pass;
  * per-shard budgets inside one pass (``shard_of``, ``shard_budget``,
    default ``fanout_shard_budget``): the items of one shard hold at most
    that many slots at a time, so one slow shard cannot take the whole
    core. The batch keys its node groups by owner shard under
    ``fanout_shard_budget``, or under one key and ``bulk_node_fanout`` when
    the shards are inactive;
  * ``submit`` puts one task on the core, for a caller that overlaps it
    with its own work (the batch's proxied sub-batches);
  * results in item order, and the first error re-raised only after the
    whole pass has drained, as ``pool.map`` would;
  * a task that fans out itself (or submits) runs on transient threads
    instead of the pool it runs on, so nested passes cannot starve each
    other into a deadlock.

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
        self.shard_budget = int(cfg.fanout_shard_budget)
        self._pool = futures.ThreadPoolExecutor(
            max_workers=self.width, thread_name_prefix="fanout-core")
        self._in_core = threading.local()

    # --- plumbing ---

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

    def submit(self, fn, item, *, kind: str = "task") -> futures.Future:
        """One task on the core (no shard budget — single submissions
        are the caller's own concurrency decision). Safe from a core
        task: falls back to a transient thread."""
        if self._nested():
            fut: futures.Future = futures.Future()

            def _run():
                try:
                    fut.set_result(self._call(fn, item, kind))
                except BaseException as exc:  # noqa: BLE001 — boundary
                    fut.set_exception(exc)

            threading.Thread(target=_run, daemon=True,
                             name="fanout-nested").start()
            return fut
        return self._pool.submit(self._call, fn, item, kind)

    def run(self, items, fn, *, kind: str = "task", shard_of=None,
            shard_budget: int | None = None) -> list:
        """fn(item) for every item, results in item order.

        shard_of(item) -> hashable names the item's shard; items of one
        shard hold at most shard_budget (default cfg) core slots at a
        time, so a stalled shard's tasks queue behind their budget
        while other shards keep flowing. The first exception re-raises
        after all items finish (pool.map parity — call sites that want
        per-item degradation catch inside fn)."""
        items = list(items)
        if not items:
            return []
        budget = self.shard_budget if shard_budget is None \
            else int(shard_budget)
        if self._nested():
            return self._run_transient(items, fn, kind, shard_of, budget)

        results: list = [None] * len(items)
        first_error: list[BaseException | None] = [None]
        inflight: dict[futures.Future, tuple[int, object]] = {}
        shard_load: dict[object, int] = {}
        waiting: dict[object, deque[int]] = {}

        def shard_key(i: int):
            if shard_of is None or budget <= 0:
                return None
            try:
                return shard_of(items[i])
            except Exception:  # noqa: BLE001 — a broken key fn must
                # not fail the pass; unkeyed items are unbudgeted
                return None

        def start(i: int, key) -> None:
            if key is not None:
                shard_load[key] = shard_load.get(key, 0) + 1
            inflight[self._pool.submit(self._call, fn, items[i],
                                       kind)] = (i, key)

        for i in range(len(items)):
            key = shard_key(i)
            if key is not None and shard_load.get(key, 0) >= budget:
                waiting.setdefault(key, deque()).append(i)
                FANOUT_SHARD_WAITS.inc()
            else:
                start(i, key)
        while inflight:
            done, _ = futures.wait(list(inflight),
                                   return_when=futures.FIRST_COMPLETED)
            for fut in done:
                i, key = inflight.pop(fut)
                try:
                    results[i] = fut.result()
                except BaseException as exc:  # noqa: BLE001 — drain
                    # the whole pass first, re-raise after (map parity)
                    if first_error[0] is None:
                        first_error[0] = exc
                if key is not None:
                    shard_load[key] -= 1
                    queue = waiting.get(key)
                    if queue:
                        start(queue.popleft(), key)
                        if not queue:
                            del waiting[key]
        if first_error[0] is not None:
            raise first_error[0]
        return results

    def _run_transient(self, items, fn, kind, shard_of, budget) -> list:
        """Nested-call fallback: bounded waves of transient threads
        (the pre-core shape) — never submits to the pool the caller is
        already running on."""
        results: list = [None] * len(items)
        errors: list = [None] * len(items)

        def _one(i: int) -> None:
            try:
                results[i] = self._call(fn, items[i], kind)
            except BaseException as exc:  # noqa: BLE001 — see run()
                errors[i] = exc

        width = max(1, budget if budget > 0 else self.width)
        for base in range(0, len(items), width):
            wave = [threading.Thread(target=_one, args=(i,), daemon=True,
                                     name="fanout-nested")
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
