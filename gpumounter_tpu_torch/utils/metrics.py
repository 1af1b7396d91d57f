"""A small Prometheus text-format registry: counters, gauges and histograms.

The counterpart of ``gpumounter_tpu/utils/metrics.py``. The original
GPUMounter exposes no metrics; both daemons of this project count mounts,
unmounts and their phase latencies. Standard library only. Metric names,
label keys and the rendered text are the reference's, byte for byte, so a
scraper or dashboard built for one reads the other.

Thread safety: every mutation of an instrument's samples (inc, set,
observe, an exemplar's capture) and every read (collect, snapshot, get)
holds that instrument's own lock; registering and render's copy of the
metric list hold the registry's lock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from gpumounter_tpu_torch.utils.locks import OrderedLock

#: The bounded label-key vocabulary: every label key of every instrument
#: comes from this set. Each key multiplies the worst-case series count, so
#: adding one says what bounds its values.
ALLOWED_LABEL_KEYS = frozenset({
    "endpoint",   # k8s API endpoint (bounded by the client surface)
    "from_state",  # quarantine transition source (health states, 4 values)
    "kind",       # record/read kind (bounded enums per subsystem)
    "method",     # RPC method name (bounded by the proto surface)
    "name",       # failpoint site name
    "node",       # node name (fleet-scoped series only)
    "objective",  # SLO objective id (bounded by config)
    "outcome",    # operation outcome enum
    "phase",      # mount/migration phase enum
    "reason",     # failure-reason enum
    "result",     # success/error result enum
    "state",      # health-state enum
    "to_state",   # quarantine transition target (health states, 4 values)
    "window",     # SLO burn window (bounded by config)
    "worker",     # worker address (fleet-scoped series only)
})


def _fmt_float(value: float) -> str:
    """A bucket bound: integral bounds bare ("1", "30"), others as the
    shortest float repr."""
    if float(value) == int(value):
        return str(int(value))
    return repr(float(value))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@dataclass
class Counter:
    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: OrderedLock = field(default_factory=lambda: OrderedLock("metrics.counter"))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> dict[tuple, float]:
        """Labels-tuple -> value, a copy."""
        with self._lock:
            return dict(self._values)

    def total(self) -> float:
        """The sum over every label set."""
        with self._lock:
            return sum(self._values.values())

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, val in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return lines


@dataclass
class Gauge:
    """A value that goes up and down. Unset, it renders 0, so that a
    scraper sees the series from the process's start."""

    name: str
    help: str
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: OrderedLock = field(default_factory=lambda: OrderedLock("metrics.gauge"))

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def get(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, val in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return lines


_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0)


def estimate_quantile(buckets: tuple, counts: list, q: float) -> float:
    """A quantile from cumulative bucket counts (Prometheus's
    histogram_quantile interpolation). `counts` holds the cumulative count
    of each bucket with the +Inf total last; the last finite bound when the
    quantile lands in +Inf."""
    total = counts[-1]
    if total <= 0:
        return 0.0
    rank = q * total
    prev_bound, prev_count = 0.0, 0
    for i, bound in enumerate(buckets):
        if counts[i] >= rank:
            span = counts[i] - prev_count
            if span <= 0:
                return bound
            return prev_bound + (bound - prev_bound) * (rank - prev_count) / span
        prev_bound, prev_count = bound, counts[i]
    return float(buckets[-1]) if buckets else 0.0


@dataclass
class Histogram:
    name: str
    help: str
    buckets: tuple = _DEFAULT_BUCKETS
    #: labels-tuple -> [cumulative counts (+Inf last), sum,
    #:                  {bucket index -> (trace_id, value, unix ts)}]
    _counts: dict[tuple, list] = field(default_factory=dict)
    _lock: OrderedLock = field(default_factory=lambda: OrderedLock("metrics.histogram"))

    def observe(self, value: float, trace_id: str = "", **labels: str) -> None:
        """Record one observation. A `trace_id` becomes the OpenMetrics
        exemplar of the bucket the value lands in (the last one wins)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            entry = self._counts.setdefault(key, [[0] * (len(self.buckets) + 1), 0.0, {}])
            counts = entry[0]
            bucket_idx = len(self.buckets)  # +Inf
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    bucket_idx = min(bucket_idx, i)
            counts[-1] += 1  # +Inf
            entry[1] += value
            if trace_id:
                entry[2][bucket_idx] = (trace_id, value, round(time.time(), 3))

    def snapshot(self) -> dict[tuple, dict]:
        """Labels-tuple -> {"counts", "sum", "exemplars"}, a deep copy."""
        with self._lock:
            return {key: {"counts": list(entry[0]), "sum": entry[1],
                          "exemplars": dict(entry[2])}
                    for key, entry in self._counts.items()}

    def quantile(self, q: float, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            entry = self._counts.get(key)
            counts = list(entry[0]) if entry else []
        if not counts:
            return 0.0
        return estimate_quantile(self.buckets, counts, q)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def collect(self, openmetrics: bool = False) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, (counts, total, exemplars) in sorted(self._counts.items()):
                labels = dict(key)
                for i, b in enumerate(self.buckets):
                    line = (f"{self.name}_bucket{_fmt_labels({**labels, 'le': _fmt_float(b)})} "
                            f"{counts[i]}")
                    lines.append(self._with_exemplar(line, exemplars.get(i), openmetrics))
                inf_line = (f"{self.name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} "
                            f"{counts[-1]}")
                lines.append(self._with_exemplar(inf_line, exemplars.get(len(self.buckets)),
                                                 openmetrics))
                lines.append(f"{self.name}_sum{_fmt_labels(labels)} {total}")
                lines.append(f"{self.name}_count{_fmt_labels(labels)} {counts[-1]}")
        return lines

    @staticmethod
    def _with_exemplar(line: str, exemplar, openmetrics: bool) -> str:
        """The exemplar suffix, in OpenMetrics renders only: the classic
        text/plain;version=0.0.4 exposition stays clean for strict parsers."""
        if not openmetrics or exemplar is None:
            return line
        trace_id, value, ts = exemplar
        return f'{line} # {{trace_id="{trace_id}"}} {value} {ts}'


class Registry:
    def __init__(self) -> None:
        self._metrics: list = []
        self._lock = OrderedLock("metrics.registry")

    def counter(self, name: str, help: str) -> Counter:
        c = Counter(name, help)
        with self._lock:
            self._metrics.append(c)
        return c

    def gauge(self, name: str, help: str) -> Gauge:
        g = Gauge(name, help)
        with self._lock:
            self._metrics.append(g)
        return g

    def histogram(self, name: str, help: str, buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        h = Histogram(name, help, buckets)
        with self._lock:
            self._metrics.append(h)
        return h

    def register(self, metric) -> None:
        """Add a custom collector: any object with name, collect() ->
        list[str] and reset() (the eBPF device-access table's adapter)."""
        with self._lock:
            self._metrics.append(metric)

    def find(self, name: str):
        """The registered instrument of this name, or None."""
        with self._lock:
            for m in self._metrics:
                if getattr(m, "name", None) == name:
                    return m
        return None

    def render(self, openmetrics: bool = False) -> str:
        """The Prometheus text exposition; `openmetrics=True` adds the
        histograms' trace-id exemplars."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            if openmetrics and isinstance(m, Histogram):
                lines.extend(m.collect(openmetrics=True))
            else:
                lines.extend(m.collect())
        return "\n".join(lines) + "\n"

    def series_count(self) -> int:
        """The number of sample lines (not comments) in the exposition."""
        return sum(1 for line in self.render().splitlines()
                   if line and not line.startswith("#"))

    def reset_all(self) -> None:
        """Zero every registered metric's samples; the instruments stay
        registered, so module-level handles keep working."""
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            m.reset()


REGISTRY = Registry()

MOUNT_TOTAL = REGISTRY.counter(
    "tpumounter_mount_total", "Total mount operations by result")
UNMOUNT_TOTAL = REGISTRY.counter(
    "tpumounter_unmount_total", "Total unmount operations by result")
MOUNT_LATENCY = REGISTRY.histogram(
    "tpumounter_mount_latency_seconds", "End-to-end hot-mount latency")
PHASE_LATENCY = REGISTRY.histogram(
    "tpumounter_phase_latency_seconds", "Per-phase latency (phase label)")
MOUNT_ROLLBACK_FAILURES = REGISTRY.counter(
    "tpumounter_mount_rollback_failures_total",
    "Failed grant undos during mount rollback — each one is a leaked "
    "cgroup grant needing operator attention")
