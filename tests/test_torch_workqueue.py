"""The elastic reconciler's work queue, on the reference's and on the port's.

Each case of ``tests/test_workqueue.py`` (the jitter's bounds, the reset on
success, the global floor under concurrent producers, the dedupe while
queued, the retry at the declared priority) and the six queue and gauge
cases of ``tests/test_elastic_intents.py`` runs on both packages'
``BackoffPolicy`` and ``RateLimitedQueue`` (and ``Gauge``), and what each
returns must be equal: the delays, the keys in the order handed out, the
depths, the gauge's readings and text, and the floor's verdicts.
"""

from __future__ import annotations

import threading
import time

import pytest

from gpumounter_tpu.elastic import workqueue as ref_workqueue
from gpumounter_tpu.utils import metrics as ref_metrics
from gpumounter_tpu_torch.elastic import workqueue
from gpumounter_tpu_torch.utils import metrics

SIDES = {"reference": (ref_workqueue, ref_metrics), "port": (workqueue, metrics)}


def jitter_within_bounds(wq, _m):
    policy = wq.BackoffPolicy(base_s=0.5, factor=2.0, cap_s=60.0, jitter=0.1)
    within = all(base <= policy.delay_for(failures) <= base * 1.1
                 for failures, base in ((1, 0.5), (2, 1.0), (3, 2.0), (5, 8.0))
                 for _ in range(200))
    # the cap bounds the delay before the jitter, which rides on top
    capped = all(60.0 <= policy.delay_for(50) <= 66.0 for _ in range(200))
    exact = wq.BackoffPolicy(base_s=0.5, factor=2.0, cap_s=60.0, jitter=0.0)
    return within, capped, policy.delay_for(0), [exact.delay_for(n) for n in (1, 2, 3)]


def backoff_resets_after_success(wq, _m):
    q = wq.RateLimitedQueue(backoff=wq.BackoffPolicy(base_s=0.5, factor=2.0, cap_s=60.0,
                                                     jitter=0.0))
    out = [q.retry("pod"), q.retry("pod"), q.retry("pod"), q.failures("pod")]
    while q.depth():
        q.get(timeout_s=3.0)
    q.forget("pod")
    return out + [q.failures("pod"), q.retry("pod"), q.retry("other")]


def global_floor_under_concurrent_enqueues(wq, _m):
    """8 producers at once; consecutive keys handed out the floor apart."""
    floor, n_keys = 0.05, 8
    q = wq.RateLimitedQueue(min_interval_s=floor)
    barrier = threading.Barrier(n_keys)

    def producer(i: int) -> None:
        barrier.wait()
        q.add(f"pod-{i}")

    threads = [threading.Thread(target=producer, args=(i,), daemon=True) for i in range(n_keys)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pops = []
    while len(pops) < n_keys:
        key = q.get(timeout_s=5.0)
        if key is None:
            return f"starved after {len(pops)} keys"
        pops.append((time.monotonic(), key))
    gaps = [b - a for (a, _), (b, _) in zip(pops, pops[1:])]
    return sorted(k for _, k in pops), all(gap >= floor - 0.005 for gap in gaps)


def concurrent_adds_of_one_key_dedupe(wq, _m):
    q = wq.RateLimitedQueue()
    barrier = threading.Barrier(8)

    def producer() -> None:
        barrier.wait()
        for _ in range(50):
            q.add("hot-pod")

    threads = [threading.Thread(target=producer, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return q.depth(), q.get(timeout_s=1.0), q.get(timeout_s=0.05)


def retry_keeps_declared_priority(wq, _m):
    """A failing high-priority key outranks fresh low-priority work."""
    q = wq.RateLimitedQueue(backoff=wq.BackoffPolicy(base_s=0.01, factor=1.0, cap_s=0.01,
                                                     jitter=0.0))
    q.add("vip", priority=10)
    out = [q.get(timeout_s=1.0)]
    q.retry("vip")
    q.add("steerage", priority=0)
    time.sleep(0.05)  # vip's 10 ms backoff passes
    return out + [q.get(timeout_s=1.0), q.get(timeout_s=1.0)]


def dedupes_and_orders_by_priority(wq, _m):
    q = wq.RateLimitedQueue(backoff=wq.BackoffPolicy(jitter=0.0))
    q.add("a/low", priority=0)
    q.add("a/low", priority=0)
    q.add("b/high", priority=5)
    return q.depth(), q.get(1.0), q.get(1.0), q.get(0.05)


def backoff_grows_and_resets(wq, _m):
    policy = wq.BackoffPolicy(base_s=0.5, factor=2.0, cap_s=4.0, jitter=0.0)
    delays = [policy.delay_for(n) for n in (0, 1, 2, 3, 4, 10)]
    q = wq.RateLimitedQueue(backoff=policy)
    out = [q.retry("k"), q.get(1.0), q.retry("k"), q.get(2.0)]
    q.forget("k")
    return delays, out + [q.retry("k")]


def retry_without_priority_keeps_the_declared(wq, _m):
    q = wq.RateLimitedQueue(backoff=wq.BackoffPolicy(base_s=0.0, jitter=0.0))
    q.add("high", priority=5)
    first = q.get(1.0)
    q.retry("high")
    q.add("low", priority=0)
    return first, q.get(1.0), q.get(1.0)


def rate_limit_spaces_dequeues(wq, _m):
    q = wq.RateLimitedQueue(min_interval_s=0.1)
    q.add("a")
    q.add("b")
    t0 = time.monotonic()
    got = [q.get(1.0) is not None, q.get(1.0) is not None]
    return got, time.monotonic() - t0 >= 0.1


def depth_gauge(wq, m):
    gauge = m.Gauge("test_depth", "d")
    q = wq.RateLimitedQueue(depth_gauge=gauge)
    q.add("x")
    q.add("y")
    out = [gauge.get()]
    q.get(1.0)
    return out + [gauge.get()]


def gauge_renders_prometheus_text(_wq, m):
    g = m.Gauge("tpumounter_test_gauge", "help text")
    empty = "\n".join(g.collect())
    g.set(3, kind="x")
    g.inc(2, kind="x")
    g.dec(1, kind="x")
    out = "\n".join(g.collect())
    return ("tpumounter_test_gauge 0" in empty, "# TYPE tpumounter_test_gauge gauge" in out,
            'tpumounter_test_gauge{kind="x"} 4.0' in out)


CASES = {
    "jitter_within_bounds": (jitter_within_bounds, (True, True, 0.0, [0.5, 1.0, 2.0])),
    "backoff_resets_after_success": (backoff_resets_after_success,
                                     [0.5, 1.0, 2.0, 3, 0, 0.5, 0.5]),
    "global_floor_under_concurrent_enqueues": (
        global_floor_under_concurrent_enqueues, (sorted(f"pod-{i}" for i in range(8)), True)),
    "concurrent_adds_of_one_key_dedupe": (concurrent_adds_of_one_key_dedupe,
                                          (1, "hot-pod", None)),
    "retry_keeps_declared_priority": (retry_keeps_declared_priority,
                                      ["vip", "vip", "steerage"]),
    "dedupes_and_orders_by_priority": (dedupes_and_orders_by_priority,
                                       (2, "b/high", "a/low", None)),
    "backoff_grows_and_resets": (backoff_grows_and_resets,
                                 ([0.0, 0.5, 1.0, 2.0, 4.0, 4.0], [0.5, "k", 1.0, "k", 0.5])),
    "retry_without_priority_keeps_the_declared": (retry_without_priority_keeps_the_declared,
                                                  ("high", "high", "low")),
    "rate_limit_spaces_dequeues": (rate_limit_spaces_dequeues, ([True, True], True)),
    "depth_gauge": (depth_gauge, [2.0, 1.0]),
    "gauge_renders_prometheus_text": (gauge_renders_prometheus_text, (True, True, True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_queue_case_ends_as_the_references(case):
    fn, want = CASES[case]
    got = {name: fn(*mods) for name, mods in SIDES.items()}
    assert got["port"] == got["reference"] == want
