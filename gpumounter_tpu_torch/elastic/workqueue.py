"""The elastic reconciler's work queue: rate-limited, with a backoff a key.

The counterpart of ``gpumounter_tpu/elastic/workqueue.py``: the shape
client-go's controllers are built on (a work queue and a rate limiter), cut
to what the reconciler needs:

  * a key a pod, deduplicated while queued: N edits of one intent cost one
    pass;
  * a backoff a key, exponential with jitter on failure and reset on
    success: a pod whose mounts keep failing retries at 0.5 s, 1 s, 2 s, ...
    up to a cap, instead of hot-looping the worker;
  * a global floor between two keys handed out: one sick intent cannot
    starve the API server or the workers of the others;
  * priority breaks ties among the keys ready at the same moment, and a
    retry keeps the key's declared priority.
"""

from __future__ import annotations

import heapq
import itertools
import random
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class BackoffPolicy:
    base_s: float = 0.5
    factor: float = 2.0
    cap_s: float = 60.0
    #: the fraction of the delay added uniformly at random, so that a herd of
    #: failures of the same age spreads out
    jitter: float = 0.1

    def delay_for(self, failures: int) -> float:
        if failures <= 0:
            return 0.0
        delay = min(self.base_s * self.factor ** (failures - 1), self.cap_s)
        if self.jitter:
            delay *= 1.0 + random.uniform(0.0, self.jitter)
        return delay


class RateLimitedQueue:
    def __init__(self, backoff: BackoffPolicy | None = None, min_interval_s: float = 0.0,
                 depth_gauge=None):
        self.backoff = backoff or BackoffPolicy()
        self.min_interval_s = min_interval_s
        self._depth_gauge = depth_gauge
        self._lock = threading.Condition()
        self._heap: list[tuple[float, int, int, str]] = []  # (ready, -priority, seq, key)
        self._queued: set[str] = set()
        self._failures: dict[str, int] = {}
        #: the last priority declared a key: a retry competes at the intent's
        #: priority, not at 0
        self._priority: dict[str, int] = {}
        self._seq = itertools.count()
        self._last_pop = 0.0

    # --- producers ---

    def add(self, key: str, priority: int = 0, delay_s: float = 0.0) -> None:
        """Enqueue; a key already waiting is not enqueued twice (a key being
        processed may queue again: the dirty/processing semantics of a work
        queue, cut to "deduplicated while queued")."""
        with self._lock:
            self._priority[key] = priority
            if key in self._queued:
                return
            self._queued.add(key)
            heapq.heappush(self._heap, (time.monotonic() + delay_s, -priority,
                                        next(self._seq), key))
            self._update_depth()
            self._lock.notify_all()

    def retry(self, key: str, priority: int | None = None) -> float:
        """Enqueue again after a failure, with the key's next backoff delay
        (at its last declared priority unless one is given); the delay."""
        with self._lock:
            failures = self._failures.get(key, 0) + 1
            self._failures[key] = failures
            if priority is None:
                priority = self._priority.get(key, 0)
        delay = self.backoff.delay_for(failures)
        self.add(key, priority=priority, delay_s=delay)
        return delay

    def forget(self, key: str) -> None:
        """Success, or the key is gone: its backoff starts afresh. Its
        priority goes too (the next add declares it again), so the keys of
        deleted pods keep no state."""
        with self._lock:
            self._failures.pop(key, None)
            if key not in self._queued:
                self._priority.pop(key, None)

    def failures(self, key: str) -> int:
        with self._lock:
            return self._failures.get(key, 0)

    # --- the consumer ---

    def get(self, timeout_s: float) -> str | None:
        """The next ready key, with each key's ready time and the global
        floor; None when none is ready in time."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                now = time.monotonic()
                wait = deadline - now
                if self._heap:
                    first_ready = max(self._heap[0][0], self._last_pop + self.min_interval_s)
                    if first_ready <= now:
                        # every key whose ready time has passed competes on
                        # priority (the heap alone serves the oldest first)
                        ready = []
                        while self._heap and self._heap[0][0] <= now:
                            ready.append(heapq.heappop(self._heap))
                        ready.sort(key=lambda item: (item[1], item[2]))
                        chosen = ready.pop(0)
                        for item in ready:
                            heapq.heappush(self._heap, item)
                        key = chosen[3]
                        self._queued.discard(key)
                        self._last_pop = now
                        self._update_depth()
                        return key
                    wait = min(wait, first_ready - now)
                if wait <= 0:
                    return None
                self._lock.wait(wait)

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def _update_depth(self) -> None:  # the caller holds _lock
        if self._depth_gauge is not None:
            self._depth_gauge.set(float(len(self._heap)))
