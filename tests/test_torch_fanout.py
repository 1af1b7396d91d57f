"""The shared fan-out core of both packages, on the same items and function.

Each case builds a ``FanoutCore`` of each package from its own ``Config``
(the same width), runs the same pass, and compares what the pass returns or
raises and what its series then hold: results in item order, the first error
re-raised only once every item has run, the most items in flight against a
pass's limit (the port's ``limit``, the reference's one shard under its
budget, as the batch calls each), a nested pass that ends with no deadlock
on a core of width 2, and the rendered series.
"""

from __future__ import annotations

import dataclasses
import os
import random
import sys
import threading
import time

import pytest

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.utils import fanout as ref_fanout
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.utils import fanout

SERIES = ("FANOUT_TASKS", "FANOUT_INFLIGHT", "FANOUT_SHARD_WAITS")


@pytest.fixture
def cores():
    """{package: (its module, a core of width 8)}; the series are zeroed
    before and the cores shut down after."""
    made = {}
    for name, mod, cfg in (("reference", ref_fanout, RefConfig().replace(fanout_width=8)),
                           ("port", fanout, dataclasses.replace(Config(), fanout_width=8))):
        for series in SERIES:
            getattr(mod, series).reset()
        made[name] = (mod, mod.FanoutCore(cfg))
    yield made
    for mod, core in made.values():
        core.shutdown()
        for series in SERIES:
            getattr(mod, series).reset()


def _rendered(mod) -> list[str]:
    return [line for series in SERIES for line in getattr(mod, series).collect()]


def _each(cores, fn) -> dict:
    return {name: fn(mod, core) for name, (mod, core) in cores.items()}


def _limited(mod, core, items, fn, kind: str, limit: int) -> list:
    """A pass of at most `limit` items in flight: the reference's call is
    its batch's, every item in shard 0 under a budget of `limit`."""
    if mod is ref_fanout:
        return core.run(items, fn, kind=kind, shard_of=lambda i: 0, shard_budget=limit)
    return core.run(items, fn, kind=kind, limit=limit)


def test_results_keep_the_items_order(cores):
    def run(mod, core):
        rng = random.Random(0)
        delays = [rng.uniform(0, 0.01) for _ in range(40)]

        def square(i):
            time.sleep(delays[i])
            return i * i

        return core.run(range(40), square, kind="order"), _rendered(mod)

    records = _each(cores, run)
    assert records["port"] == records["reference"]
    assert records["port"][0] == [i * i for i in range(40)]
    assert 'tpumounter_fanout_tasks_total{kind="order"} 40.0' in records["port"][1]


def test_the_first_error_is_raised_after_every_item_ran(cores):
    def run(mod, core):
        ran, lock = [], threading.Lock()

        def fn(i):
            time.sleep(0.002 * (i % 5))
            with lock:
                ran.append(i)
            if i in (3, 11):
                raise ValueError(f"item {i} failed")
            return i

        with pytest.raises(ValueError) as exc:
            core.run(range(16), fn, kind="errors")
        return str(exc.value) in ("item 3 failed", "item 11 failed"), sorted(ran), _rendered(mod)

    records = _each(cores, run)
    assert records["port"] == records["reference"]
    assert records["port"][:2] == (True, list(range(16)))


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_a_pass_holds_at_most_its_limit(cores, limit):
    """20 items under a limit below the core's width: the items in flight
    never pass the limit, and reach it; the items parked behind it are
    counted."""
    def run(mod, core):
        state, lock = {"now": 0, "most": 0}, threading.Lock()

        def fn(i):
            with lock:
                state["now"] += 1
                state["most"] = max(state["most"], state["now"])
            time.sleep(0.01)
            with lock:
                state["now"] -= 1
            return i

        out = _limited(mod, core, range(20), fn, "limit", limit)
        return out, state["most"], mod.FANOUT_SHARD_WAITS.total(), _rendered(mod)

    records = _each(cores, run)
    assert records["port"] == records["reference"]
    assert records["port"][:3] == (list(range(20)), limit, 20 - limit)


def test_a_nested_pass_ends_without_a_deadlock(cores):
    """Each of 4 items of a pass on a core of width 2 runs a pass of its own:
    a nested pass that waited for the core's own threads would never end.
    Both packages end within the test's own limit, with the same results."""
    def run(mod, core):
        small = mod.FanoutCore(RefConfig().replace(fanout_width=2) if mod is ref_fanout
                               else dataclasses.replace(Config(), fanout_width=2))
        out = {}

        def outer(i):
            return (small.run(range(3), lambda j: (i, j), kind="inner"),
                    _limited(mod, small, [i], lambda x: x + 1, "inner", 1))

        worker = threading.Thread(target=lambda: out.update(
            result=small.run(range(4), outer, kind="outer")), daemon=True)
        worker.start()
        worker.join(timeout=20)
        small.shutdown()
        assert not worker.is_alive(), f"{mod.__name__}: the nested pass did not end"
        return out["result"], _rendered(mod)

    records = _each(cores, run)
    assert records["port"] == records["reference"]
    assert records["port"][0] == [([(i, j) for j in range(3)], [i + 1]) for i in range(4)]


def test_the_process_core_and_its_series(cores):
    """``get_core`` is one core a process, sized by its first caller;
    ``reset_core`` drops it. The series render as the reference's."""
    fanout.reset_core()
    first = fanout.get_core(dataclasses.replace(Config(), fanout_width=3))
    assert fanout.get_core(dataclasses.replace(Config(), fanout_width=9)) is first
    assert first.width == 3
    fanout.reset_core()
    assert fanout.get_core().width == max(32, 4 * (os.cpu_count() or 8))
    fanout.reset_core()
    records = _each(cores, lambda mod, core: (core.run([], len), core.run(
        ["abc"], len, kind="one"), _rendered(mod)))
    assert records["port"] == records["reference"]
    assert records["port"][2] == [
        "# HELP tpumounter_fanout_tasks_total tasks executed on the shared fan-out core, by kind",
        "# TYPE tpumounter_fanout_tasks_total counter",
        'tpumounter_fanout_tasks_total{kind="one"} 1.0',
        "# HELP tpumounter_fanout_inflight tasks currently running on the shared fan-out core",
        "# TYPE tpumounter_fanout_inflight gauge",
        "tpumounter_fanout_inflight 0.0",
        "# HELP tpumounter_fanout_shard_waits_total task submissions parked behind a "
        "per-shard concurrency budget",
        "# TYPE tpumounter_fanout_shard_waits_total counter",
        "tpumounter_fanout_shard_waits_total 0"]


def test_a_crowded_core_loses_no_task(cores):
    """More threads than cores, the interpreter switching threads as often as
    it can: every item's result lands in its place, and the series count
    every task and end with none in flight."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(mod, core):
            wide = mod.FanoutCore(RefConfig().replace(fanout_width=64) if mod is ref_fanout
                                  else dataclasses.replace(Config(), fanout_width=64))
            try:
                out = _limited(mod, wide, range(2000), lambda i: -i, "crowd", 5)
            finally:
                wide.shutdown()
            return (out == [-i for i in range(2000)], mod.FANOUT_TASKS.get(kind="crowd"),
                    mod.FANOUT_INFLIGHT.get(), mod.FANOUT_SHARD_WAITS.total())

        records = _each(cores, run)
    finally:
        sys.setswitchinterval(interval)
    assert records["port"][:3] == records["reference"][:3] == (True, 2000.0, 0.0)
    assert records["port"][3] > 0 and records["reference"][3] > 0
