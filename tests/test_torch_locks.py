"""The port's lock-order recorder (``gpumounter_tpu_torch/utils/locks.py``).

Held to ``tests/test_tpulint.py``'s recorder cases, which need no static
graph: each runs on both packages' modules and must end the same way. Then
the port's own: the named locks of its modules land in the recorder as
nested acquisitions, and the cycle search names a path.
"""

from __future__ import annotations

import threading

import pytest

from gpumounter_tpu.utils import locks as ref_locks
from gpumounter_tpu_torch.utils import locks

SIDES = {"reference": ref_locks, "port": locks}


@pytest.mark.parametrize("side", list(SIDES))
def test_recorder_detects_reversed_acquisition(side):
    lk = SIDES[side]
    recorder = lk.LockOrderRecorder()
    for outer, inner in (("a", "b"), ("b", "a")):
        recorder.note_acquired(outer)
        recorder.note_acquired(inner)
        recorder.note_released(inner)
        recorder.note_released(outer)
    with pytest.raises(lk.LockOrderViolation) as err:
        recorder.assert_consistent()
    assert "a -> b -> a" in str(err.value) or "b -> a -> b" in str(err.value)


@pytest.mark.parametrize("side", list(SIDES))
def test_recorder_contradiction_with_a_static_graph(side):
    lk = SIDES[side]
    recorder = lk.LockOrderRecorder()
    recorder.note_acquired("metrics.counter")
    recorder.note_acquired("worker.ledger")
    recorder.note_released("worker.ledger")
    recorder.note_released("metrics.counter")
    recorder.assert_consistent()
    with pytest.raises(lk.LockOrderViolation):
        recorder.assert_consistent(static_edges={("worker.ledger", "metrics.counter")})


@pytest.mark.parametrize("side", list(SIDES))
def test_ordered_condition_wait_restores_holding(side):
    lk = SIDES[side]
    cv = lk.OrderedCondition("fixture.cv")
    with cv:
        assert "fixture.cv" in lk.held_locks()
        cv.wait(timeout=0.01)
        assert "fixture.cv" in lk.held_locks()
    assert "fixture.cv" not in lk.held_locks()


@pytest.mark.parametrize("side", list(SIDES))
def test_find_cycle_reports_path(side):
    find_cycle = SIDES[side].find_cycle
    assert find_cycle({("a", "b"), ("b", "c")}) is None
    cycle = find_cycle({("a", "b"), ("b", "c"), ("c", "a")})
    assert cycle[0] == cycle[-1] and set(cycle) == {"a", "b", "c"}
    assert find_cycle({("a", "a")}) == ["a", "a"]


def test_the_cycle_search_and_the_dump_equal_the_references():
    """On the same edge sets the two searches return the same path, and two
    recorders fed the same nestings dump the same JSON (threads named alike)."""
    graphs = [{("a", "b"), ("b", "c"), ("c", "a")}, {("x", "y"), ("y", "z"), ("z", "y")},
              {("p", "q"), ("q", "r")}]
    for edges in graphs:
        assert locks.find_cycle(edges) == ref_locks.find_cycle(edges)
    dumps = []
    for lk in SIDES.values():
        recorder = lk.LockOrderRecorder()

        def feed(recorder=recorder):
            for name in ("outer", "inner", "inner"):
                recorder.note_acquired(name)
            for name in ("inner", "inner", "outer"):
                recorder.note_released(name)

        thread = threading.Thread(target=feed, name="fixture-thread")
        thread.start()
        thread.join()
        dumps.append(recorder.dump())
    assert dumps[0] == dumps[1]
    assert dumps[0]["edges"] == [["outer", "inner"]]
    assert dumps[0]["same_name_nestings"] == ["inner"]


def test_the_ports_named_locks_record_their_nesting():
    """Every OrderedLock of the port feeds the global recorder: a metrics
    increment under the ledger's lock is an edge worker.ledger ->
    metrics.counter, and releasing leaves nothing held."""
    from gpumounter_tpu_torch.utils.metrics import Counter
    ledger_lock = locks.OrderedLock("worker.ledger")
    counter = Counter("fixture_total", "a fixture")
    with ledger_lock:
        assert locks.held_locks()[-1] == "worker.ledger"
        counter.inc()
    assert "worker.ledger" not in locks.held_locks()
    assert ("worker.ledger", "metrics.counter") in locks.RECORDER.edges()
    locks.RECORDER.assert_consistent()


def test_a_lock_needs_a_name():
    with pytest.raises(ValueError):
        locks.OrderedLock("")
    with pytest.raises(ValueError):
        locks.OrderedCondition("")
