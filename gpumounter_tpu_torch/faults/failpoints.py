"""Failpoint registry: named fault-injection sites in the hot control paths.

The counterpart of ``gpumounter_tpu/faults/failpoints.py``, whole: the spec
grammar, the nine kinds, the registry-owned RNG of the probabilistic kinds,
``armed(...)``, ``TPUMOUNTER_FAILPOINTS`` read at import, and
``tpumounter_failpoint_fires_total``. The sites the port threads through its
modules are declared in ``faults/registry.py``.

The control plane now mutates running pods from three cooperating planes
(slice ops, elastic reconciler, migrate orchestrator); a crash or
partition at the wrong instant can leak chips, double-mount a device, or
strand a journal. The chaos harness (testing/chaos.py) needs a way to
*force* those instants deterministically, and operators need a way to
reproduce a production symptom on a dev cluster. Failpoints are that
mechanism — the shape of Go's pingcap/failpoint and etcd's gofail,
reduced to what this codebase needs:

  * A site is one `fire("plane.site", **ctx)` (or `value(name, default)`)
    call threaded through production code. With nothing armed the entire
    registry is one module-bool check — zero allocations, no lock.
  * Arming is per-name with a spec string:  `NAME=ACTION` where
        ACTION := TERM ( '->' TERM )*
        TERM   := [COUNT*]KIND[(ARG)]
        KIND   := off | pass | error | crash | delay | unavailable | return
    A COUNT-limited term consumes itself after firing COUNT times and the
    next term takes over; when the last term is spent the point disarms
    (`1*error(boom)` fires exactly once; `1*pass->1*error(boom)` lets the
    first activation through and fails the second — gofail's sequencing).
    A schedule of count-limited faults laid down before an operation is
    therefore guaranteed spent afterwards.
  * Sources: the TPUMOUNTER_FAILPOINTS env var (read at import, the
    config/deploy path) or the programmatic API (`arm`, `arm_spec`,
    `armed(...)` context manager — the test path).

Action semantics at a `fire()` site:
  error(msg)        raise FailpointError(msg)
  crash(msg)        raise CrashError(msg) — simulates the PROCESS dying at
                    this instant: callers that model crash-consistency
                    (migrate orchestrator, mounter undo) deliberately let
                    it bypass their cleanup paths.
  delay(seconds)    time.sleep(seconds), then continue (slow reply /
                    network latency).
  unavailable(msg)  raise InjectedUnavailable — the RPC client treats it
                    exactly like a dropped connection (retriable).
  pdelay([p, s])    with probability p, time.sleep(s); otherwise pass.
                    The gray-failure shape: a limping node is not DOWN,
                    it is intermittently slow — deterministic delay()
                    makes every call slow (an outage), pdelay makes SOME
                    calls slow (a degradation the liveness probes miss).
  pdrop(p)          with probability p, raise InjectedUnavailable;
                    otherwise pass. Intermittent packet loss / flaky NIC.
                    Draws come from a registry-owned RNG — `seed(n)`
                    before a scenario makes a chaos run reproducible.
  return(v)         no-op at fire() sites; at `value()` sites the parsed
                    v (JSON when possible) replaces the default — used
                    for deadline overrides, k8s status-code injection,
                    and behavior switches like rollback-skip.

This module is stdlib-only on purpose: it is imported by the mount path,
which must stay importable without grpc (utils/lazy_grpc.py policy).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass

from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("faults")

ENV_VAR = "TPUMOUNTER_FAILPOINTS"

FAILPOINT_FIRES = REGISTRY.counter(
    "tpumounter_failpoint_fires_total",
    "Armed failpoint activations by site name")


class FailpointError(RuntimeError):
    """Generic injected failure (the `error` action)."""


class CrashError(RuntimeError):
    """Injected process death (the `crash` action).

    Handlers that model crash-consistency must re-raise this BEFORE
    running their undo/rollback logic — the whole point of the action is
    that a real crash gets no chance to clean up.
    """


class InjectedUnavailable(RuntimeError):
    """Injected transport drop; the RPC client retries it like
    StatusCode.UNAVAILABLE."""


_KINDS = ("off", "pass", "error", "crash", "delay", "unavailable", "return",
          "pdelay", "pdrop")


@dataclass
class _Action:
    kind: str
    arg: object = None
    remaining: int | None = None  # None = unlimited


class FailpointSpecError(ValueError):
    pass


def _parse_term(raw: str) -> _Action:
    raw = raw.strip()
    count: int | None = None
    # '*' only separates a count when it appears before the argument
    # parens — error(reset by peer *) must keep its literal asterisk.
    star = raw.find("*")
    paren = raw.find("(")
    if star != -1 and (paren == -1 or star < paren):
        count_raw, full = raw[:star], raw
        raw = raw[star + 1:]
        try:
            count = int(count_raw)
        except ValueError:
            raise FailpointSpecError(f"bad count {count_raw!r} in {full!r}")
        if count <= 0:
            raise FailpointSpecError(f"count must be positive: {count}")
    arg: object = None
    if "(" in raw:
        kind, _, rest = raw.partition("(")
        if not rest.endswith(")"):
            raise FailpointSpecError(f"unbalanced parens in {raw!r}")
        arg_raw = rest[:-1]
        try:
            arg = json.loads(arg_raw)
        except ValueError:
            arg = arg_raw  # bare strings allowed: error(boom)
    else:
        kind = raw
    kind = kind.strip()
    if kind not in _KINDS:
        raise FailpointSpecError(
            f"unknown failpoint action {kind!r} (one of {', '.join(_KINDS)})")
    if kind == "delay":
        try:
            arg = float(arg)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            raise FailpointSpecError(f"delay needs a number: {raw!r}")
    if kind == "pdelay":
        try:
            p, seconds = arg  # type: ignore[misc]
            arg = (float(p), float(seconds))
        except (TypeError, ValueError):
            raise FailpointSpecError(
                f"pdelay needs [probability, seconds]: {raw!r}")
        if not 0.0 <= arg[0] <= 1.0:
            raise FailpointSpecError(
                f"pdelay probability must be in [0, 1]: {raw!r}")
    if kind == "pdrop":
        try:
            arg = float(arg)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            raise FailpointSpecError(
                f"pdrop needs a probability: {raw!r}")
        if not 0.0 <= arg <= 1.0:
            raise FailpointSpecError(
                f"pdrop probability must be in [0, 1]: {raw!r}")
    return _Action(kind=kind, arg=arg, remaining=count)


def _split_clauses(spec: str) -> list[str]:
    """Split on ';'/',' only at paren depth 0."""
    out, buf, depth = [], [], 0
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch in ";," and depth == 0:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    out.append("".join(buf))
    return out


def _parse_action(raw: str) -> list[_Action]:
    terms = [_parse_term(term) for term in raw.split("->")]
    for term in terms[:-1]:
        if term.remaining is None:
            raise FailpointSpecError(
                f"only the last term of {raw!r} may be uncounted — an "
                f"unlimited term would shadow everything after it")
    return terms


class Registry:
    """Holds the armed points. One global instance (`fire`/`value` module
    functions); tests may build private ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, list[_Action]] = {}
        self._hits: dict[str, int] = {}
        #: read WITHOUT the lock on the hot path; Python attribute reads
        #: of a bool are atomic, and a stale False only delays arming by
        #: one call — never corrupts state.
        self._any_armed = False
        #: one RNG per registry, seeded constant so an un-seeded run is
        #: still reproducible; `seed(n)` rewinds it before a scenario.
        self._rng = random.Random(0)

    def seed(self, n: int) -> None:
        """Rewind the probabilistic-action RNG (pdelay/pdrop draws), so a
        chaos scenario replays the same coin flips for the same seed."""
        with self._lock:
            self._rng.seed(n)

    # --- arming ---

    def arm(self, name: str, action: str) -> None:
        terms = _parse_action(action)
        with self._lock:
            if len(terms) == 1 and terms[0].kind == "off":
                self._points.pop(name, None)
            else:
                self._points[name] = terms
            self._any_armed = bool(self._points)
        logger.warning("failpoint %s armed: %s", name, action)

    def arm_spec(self, spec: str) -> None:
        """`name=action;name=action...` (';' or ',' separated — but only
        outside parens, so JSON args like return([409, 500]) survive)."""
        for clause in _split_clauses(spec):
            clause = clause.strip()
            if not clause:
                continue
            name, sep, action = clause.partition("=")
            if not sep:
                raise FailpointSpecError(
                    f"failpoint clause needs NAME=ACTION: {clause!r}")
            self.arm(name.strip(), action)

    def disarm(self, name: str) -> None:
        with self._lock:
            self._points.pop(name, None)
            self._any_armed = bool(self._points)

    def disarm_all(self) -> None:
        with self._lock:
            self._points.clear()
            self._hits.clear()
            self._any_armed = False

    def is_armed(self, name: str) -> bool:
        with self._lock:
            return name in self._points

    def active(self) -> dict[str, str]:
        with self._lock:
            return {name: "->".join(a.kind for a in terms)
                    for name, terms in self._points.items()}

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    # --- firing ---

    def _take(self, name: str) -> _Action | None:
        """Consume one activation (the head term); caller executes it
        outside the lock."""
        with self._lock:
            terms = self._points.get(name)
            if not terms:
                return None
            self._hits[name] = self._hits.get(name, 0) + 1
            action = terms[0]
            if action.remaining is not None:
                action.remaining -= 1
                if action.remaining <= 0:
                    terms.pop(0)
                    if not terms:
                        del self._points[name]
                        self._any_armed = bool(self._points)
            return action

    def _coin(self, p: float) -> bool:
        # Under the lock: Random is not documented thread-safe, and a
        # serialized draw order is what makes seeded runs reproducible.
        with self._lock:
            return self._rng.random() < p

    def fire(self, name: str, /, **ctx) -> None:
        """Injection site. Zero-cost unless something is armed.
        (`name` is positional-only so ctx may carry its own `name`.)"""
        if not self._any_armed:
            return
        action = self._take(name)
        if action is None or action.kind == "pass":
            return
        if action.kind == "pdelay":
            p, seconds = action.arg  # type: ignore[misc]
            if not self._coin(p):
                return  # the lucky call: no count, no log spam
            FAILPOINT_FIRES.inc(name=name)
            time.sleep(seconds)
            return
        if action.kind == "pdrop":
            if not self._coin(float(action.arg)):  # type: ignore[arg-type]
                return
            FAILPOINT_FIRES.inc(name=name)
            raise InjectedUnavailable(
                f"failpoint {name}: injected drop (p={action.arg})")
        FAILPOINT_FIRES.inc(name=name)
        detail = action.arg if action.arg is not None else name
        logger.warning("failpoint %s firing %s%s ctx=%s", name, action.kind,
                       f"({action.arg})" if action.arg is not None else "",
                       ctx)
        if action.kind == "error":
            raise FailpointError(f"failpoint {name}: {detail}")
        if action.kind == "crash":
            raise CrashError(f"failpoint {name} (simulated crash): {detail}")
        if action.kind == "unavailable":
            raise InjectedUnavailable(f"failpoint {name}: {detail}")
        if action.kind == "delay":
            time.sleep(float(action.arg))
        # "return" is inert at fire() sites

    def value(self, name: str, default=None, /, **ctx):
        """Value-override site: the armed `return(v)` replaces `default`.
        Non-`return` actions behave exactly like fire() here, so a site
        can be both overridden and failed."""
        if not self._any_armed:
            return default
        action = self._take(name)
        if action is None or action.kind == "pass":
            return default
        if action.kind == "pdelay":
            p, seconds = action.arg  # type: ignore[misc]
            if self._coin(p):
                FAILPOINT_FIRES.inc(name=name)
                time.sleep(seconds)
            return default
        if action.kind == "pdrop":
            if not self._coin(float(action.arg)):  # type: ignore[arg-type]
                return default
            FAILPOINT_FIRES.inc(name=name)
            raise InjectedUnavailable(
                f"failpoint {name}: injected drop (p={action.arg})")
        FAILPOINT_FIRES.inc(name=name)
        logger.warning("failpoint %s (value) firing %s(%s) ctx=%s",
                       name, action.kind, action.arg, ctx)
        if action.kind == "return":
            return action.arg
        if action.kind == "error":
            raise FailpointError(f"failpoint {name}: {action.arg or name}")
        if action.kind == "crash":
            raise CrashError(
                f"failpoint {name} (simulated crash): {action.arg or name}")
        if action.kind == "unavailable":
            raise InjectedUnavailable(f"failpoint {name}: {action.arg or name}")
        if action.kind == "delay":
            time.sleep(float(action.arg))
        return default


_REGISTRY = Registry()

arm = _REGISTRY.arm
arm_spec = _REGISTRY.arm_spec
disarm = _REGISTRY.disarm
disarm_all = _REGISTRY.disarm_all
is_armed = _REGISTRY.is_armed
active = _REGISTRY.active
hits = _REGISTRY.hits
fire = _REGISTRY.fire
value = _REGISTRY.value
seed = _REGISTRY.seed


class armed:
    """Context manager for tests: arm a schedule, restore the previous
    registry state on exit (including points the schedule consumed).

        with failpoints.armed({"worker.mount.mknod": "1*error(boom)"}):
            ...
    """

    def __init__(self, schedule: dict[str, str] | str):
        self._schedule = schedule
        self._saved: dict[str, list[_Action]] | None = None

    def __enter__(self):
        import copy
        with _REGISTRY._lock:
            # Deep copy: firing mutates term counters in place.
            self._saved = copy.deepcopy(_REGISTRY._points)
        if isinstance(self._schedule, str):
            arm_spec(self._schedule)
        else:
            for name, action in self._schedule.items():
                arm(name, action)
        return _REGISTRY

    def __exit__(self, *exc):
        with _REGISTRY._lock:
            _REGISTRY._points = dict(self._saved or {})
            _REGISTRY._any_armed = bool(_REGISTRY._points)
        return False


def _arm_from_env() -> None:
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        logger.warning("arming failpoints from %s=%r", ENV_VAR, spec)
        arm_spec(spec)


_arm_from_env()
