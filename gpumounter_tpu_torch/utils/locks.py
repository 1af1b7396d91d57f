"""Named, order-recorded locks: the runtime half of the lock-order check.

The counterpart of ``gpumounter_tpu/utils/locks.py``. Every acquisition of an
:class:`OrderedLock` or :class:`OrderedCondition` while another one is held
records the observed nesting (outer name -> inner name) into the
process-global :class:`LockOrderRecorder`. The chaos harness asserts after
every scenario that the observed edges are acyclic (invariant 15), so an
order that could deadlock a master fails a test instead.

A node of the graph is a lock's NAME, not its instance: every
``OrderedLock("metrics.counter")`` is one node. Two instances of one name
nested inside each other collapse to a self-edge, which is recorded apart
(``same_name_nestings``) and left out of the cycle search, since names cannot
order instances; keep same-named locks at the leaves (the metrics
instruments do).

The static half (the reference's ``tools/tpulint`` graph, which reads the
reference's sources only) has no counterpart here; ``assert_consistent``
still takes a static edge set from its caller. Stdlib only: the metrics
registry imports this module, and the mount path imports that.
"""

from __future__ import annotations

import threading

__all__ = [
    "OrderedLock",
    "OrderedCondition",
    "LockOrderRecorder",
    "LockOrderViolation",
    "RECORDER",
    "find_cycle",
    "held_locks",
]


class LockOrderViolation(AssertionError):
    """The observed acquisition orders admit a deadlock (a cycle), or
    contradict the statically-extracted nesting graph."""


def find_cycle(edges) -> list[str] | None:
    """First cycle in a directed graph given as (src, dst) pairs, as a
    node path ``[a, b, ..., a]``; None when acyclic. Self-edges are the
    caller's business — this reports them as ``[a, a]``."""
    graph: dict[str, list[str]] = {}
    for src, dst in edges:
        graph.setdefault(src, []).append(dst)
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    parent: dict[str, str] = {}
    for root in sorted(graph):
        if color.get(root, WHITE) != WHITE:
            continue
        stack: list[tuple[str, int]] = [(root, 0)]
        color[root] = GREY
        while stack:
            node, idx = stack[-1]
            neighbours = graph.get(node, [])
            if idx >= len(neighbours):
                color[node] = BLACK
                stack.pop()
                continue
            stack[-1] = (node, idx + 1)
            nxt = neighbours[idx]
            state = color.get(nxt, WHITE)
            if state == GREY:
                if nxt == node:
                    return [node, node]
                # Walk parents back from `node` to `nxt`, then close.
                path = [node]
                cur = node
                while cur != nxt:
                    cur = parent[cur]
                    path.append(cur)
                path.reverse()
                return path + [nxt]
            if state == WHITE:
                color[nxt] = GREY
                parent[nxt] = node
                stack.append((nxt, 0))
    return None


class LockOrderRecorder:
    """Process-global observed-nesting ledger.

    Per-thread held-lock stacks live in a threading.local; each first
    observation of (outer-name, inner-name) lands in ``_edges`` with the
    thread name and full held stack that witnessed it — the evidence a
    violation report prints. The guard is a plain threading.Lock (an
    OrderedLock here would recurse into its own bookkeeping).
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: (outer, inner) -> {"thread": ..., "stack": [...]} first witness
        self._edges: dict[tuple[str, str], dict] = {}
        #: names seen nested inside a region of the SAME name
        self._same_name: dict[str, dict] = {}
        self._tls = threading.local()

    # --- per-thread stack ---

    def _stack(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquired(self, name: str) -> None:
        stack = self._stack()
        if stack:
            outer = stack[-1]
            if outer == name:
                if name not in self._same_name:
                    with self._mu:
                        self._same_name.setdefault(
                            name, {"thread": threading.current_thread().name,
                                   "stack": list(stack)})
            else:
                key = (outer, name)
                if key not in self._edges:  # racy fast-path; mu settles it
                    with self._mu:
                        self._edges.setdefault(
                            key, {"thread": threading.current_thread().name,
                                  "stack": list(stack) + [name]})
        stack.append(name)

    def note_released(self, name: str) -> None:
        stack = self._stack()
        # LIFO in the `with` discipline; tolerate out-of-order release.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # --- reads ---

    def edges(self) -> set[tuple[str, str]]:
        with self._mu:
            return set(self._edges)

    def witnesses(self) -> dict[tuple[str, str], dict]:
        with self._mu:
            return {k: dict(v) for k, v in self._edges.items()}

    def same_name_nestings(self) -> set[str]:
        with self._mu:
            return set(self._same_name)

    def dump(self) -> dict:
        """The recorder as JSON: its edges, their witnesses and the
        same-name nestings."""
        with self._mu:
            return {
                "edges": sorted([list(k) for k in self._edges]),
                "witnesses": {f"{a}->{b}": dict(w)
                              for (a, b), w in sorted(self._edges.items())},
                "same_name_nestings": sorted(self._same_name),
            }

    def clear(self) -> None:
        with self._mu:
            self._edges.clear()
            self._same_name.clear()

    # --- validation ---

    def assert_consistent(self, static_edges=None) -> None:
        """Raise LockOrderViolation when the observed edges contain a
        cycle, or — given the static nesting graph — when combining the
        two produces one (an observed order the static graph forbids).
        """
        observed = self.edges()
        cycle = find_cycle(observed)
        if cycle is not None:
            raise LockOrderViolation(
                "observed lock acquisitions form a cycle (potential "
                f"deadlock): {' -> '.join(cycle)}; witnesses: "
                f"{self._cycle_witnesses(cycle)}")
        if static_edges:
            combined = observed | {tuple(e) for e in static_edges
                                   if e[0] != e[1]}
            cycle = find_cycle(combined)
            if cycle is not None:
                dynamic = [e for e in zip(cycle, cycle[1:])
                           if e in observed]
                raise LockOrderViolation(
                    "observed acquisition order contradicts the static "
                    f"lock graph: cycle {' -> '.join(cycle)} (observed "
                    f"edges in it: {dynamic}; witnesses: "
                    f"{self._cycle_witnesses(cycle)})")

    def _cycle_witnesses(self, cycle: list[str]) -> dict:
        pairs = set(zip(cycle, cycle[1:]))
        with self._mu:
            return {f"{a}->{b}": self._edges[(a, b)]["stack"]
                    for (a, b) in pairs if (a, b) in self._edges}


RECORDER = LockOrderRecorder()


def held_locks() -> list[str]:
    """This thread's currently-held OrderedLock names, outermost first
    (a debugging/assertion hook for tests)."""
    return list(RECORDER._stack())


class OrderedLock:
    """A named threading.Lock that records observed nesting into the
    global RECORDER. Drop-in for the ``with lock:`` / acquire/release
    discipline; the name is the node id in the lock-order graph."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        if not name:
            raise ValueError("OrderedLock needs a non-empty name")
        self.name = name
        self._inner = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            RECORDER.note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        RECORDER.note_released(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name!r}>"


class OrderedCondition:
    """A named threading.Condition (RLock-backed, like the bare
    constructor) with the same nesting bookkeeping. ``wait`` fully
    releases the underlying lock, so the held-stack entry (or entries,
    under reentrant acquisition) is removed for the wait's duration and
    restored — with re-recorded edges — on wakeup."""

    def __init__(self, name: str):
        if not name:
            raise ValueError("OrderedCondition needs a non-empty name")
        self.name = name
        self._inner = threading.Condition()

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            RECORDER.note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        RECORDER.note_released(self.name)

    def __enter__(self) -> "OrderedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: float | None = None) -> bool:
        held = self._drop_all()
        try:
            return self._inner.wait(timeout)
        finally:
            self._restore(held)

    def wait_for(self, predicate, timeout: float | None = None):
        # Delegating to the inner wait_for would bypass our wait()'s
        # stack bookkeeping; re-implement on top of self.wait.
        import time as _time
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def _drop_all(self) -> int:
        """Remove every reentrant held-stack entry for this name (wait
        releases the RLock completely); returns the count to restore."""
        stack = RECORDER._stack()
        count = stack.count(self.name)
        for _ in range(count):
            RECORDER.note_released(self.name)
        return count

    def _restore(self, count: int) -> None:
        for _ in range(count):
            RECORDER.note_acquired(self.name)

    def __repr__(self) -> str:
        return f"<OrderedCondition {self.name!r}>"
