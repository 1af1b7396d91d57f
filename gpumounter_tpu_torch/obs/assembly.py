"""Fleet-wide trace assembly and critical-path attribution.

The counterpart of ``gpumounter_tpu/obs/assembly.py``. Spans live in each
process's ring; here the master's and the workers' halves meet:

  * ``RemoteSpanStore``: the master's bounded store of the spans workers
    export. A worker ships its ring inside the CollectTelemetry snapshot
    (``obs/fleet.py``'s "spans"; the scrape fallback carries none), and the
    ``FleetCollector`` ingests them here, deduplicated by span id, so a
    cumulative ring sent again costs nothing.
  * ``assemble``: joins the local ring with the federated spans by trace id
    into one operation tree, flags what is missing (orphan spans whose
    parent never arrived; rpc client spans without their worker half), and
    charges every instant of the operation's wall time to exactly one
    PHASE by walking the tree's wall-clock intervals: a child's window to
    the child's phase, uncovered time to the owning span's own phase, and
    the overlap of parallel siblings once, to the earliest. By construction
    the phases sum to the root span's wall time, which chaos invariant 16
    asserts.
  * ``fleet_dominant_phase``: the same attribution summed over the newest
    mount-shaped edge spans, so that the SLO engine's ``GPUSLOBurnRate``
    breach names where the latency budget goes.

The phase prefixes are the reference's: the port's span names share them
(``rpc.AddGPU`` is an ``rpc.`` span as ``rpc.AddTPU`` is). Standard library
only: the worker and the master both import it.
"""

from __future__ import annotations

from collections import OrderedDict

from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("obs.assembly")

REMOTE_SPANS_INGESTED = REGISTRY.counter(
    "tpumounter_remote_spans_ingested_total",
    "Worker spans newly federated into the master's remote-span store "
    "(re-sent spans dedupe by span id and are not counted)")
REMOTE_SPAN_EVICTIONS = REGISTRY.counter(
    "tpumounter_remote_span_evictions_total",
    "Federated worker spans dropped from the remote-span store by "
    "capacity pressure (raise TPUMOUNTER_REMOTE_SPAN_CAPACITY)")

#: span-name prefix -> phase, the FIRST match wins (the specific
#: http.admission before the http. edge); an unknown name falls back to its
#: first dotted segment
PHASES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("admission", ("http.admission",)),
    ("shard_proxy", ("proxy.",)),
    ("k8s_api", ("k8s.",)),
    ("slave_pod_schedule", ("mount.slave_pod_schedule",)),
    ("cgroup_grant", ("mount.cgroup_grant", "unmount.cgroup_revoke")),
    ("verify", ("mount.verify",)),
    ("mknod", ("mount.mknod", "unmount.device_remove")),
    ("rollback", ("mount.rollback",)),
    ("worker", ("worker.",)),
    ("rpc", ("rpc.",)),
    ("migrate", ("migrate.",)),
    ("edge", ("http.", "chaos.", "slice.", "bulk.", "elastic.")),
)

#: rpc client spans whose worker half is a scrape's and not an operation's:
#: its absence is no incomplete assembly
_RPC_NO_WORKER_HALF = frozenset({"rpc.CollectTelemetry"})


def phase_of(name: str) -> str:
    for phase, prefixes in PHASES:
        for prefix in prefixes:
            if name.startswith(prefix):
                return phase
    return name.split(".", 1)[0] if name else "unknown"


class RemoteSpanStore:
    """The master's bounded store of federated worker spans: keyed by span
    id (a worker sends its whole ring every pass), with an index by trace
    for the /trace join; the oldest ingested go first (a join buffer: the
    JSONL sinks are the archive)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._lock = OrderedLock("assembly.remote")
        self._spans: OrderedDict[str, dict] = OrderedDict()
        self._by_trace: dict[str, set[str]] = {}

    def ingest(self, node: str, spans) -> int:
        """Store every span not seen yet, stamped with its node; returns how
        many were new. A malformed entry is skipped, never raised."""
        if not isinstance(spans, (list, tuple)):
            return 0
        new = evicted = 0
        with self._lock:
            for span in spans:
                if not isinstance(span, dict):
                    continue
                sid, tid = span.get("span_id"), span.get("trace_id")
                if not sid or not tid or not isinstance(sid, str) or not isinstance(tid, str):
                    continue
                if sid in self._spans:
                    continue
                self._spans[sid] = {**span, "node": node}
                self._by_trace.setdefault(tid, set()).add(sid)
                new += 1
            while len(self._spans) > max(1, self.capacity):
                old_sid, old = self._spans.popitem(last=False)
                ids = self._by_trace.get(old.get("trace_id", ""))
                if ids is not None:
                    ids.discard(old_sid)
                    if not ids:
                        self._by_trace.pop(old.get("trace_id", ""), None)
                evicted += 1
        if new:
            REMOTE_SPANS_INGESTED.inc(float(new))
        if evicted:
            REMOTE_SPAN_EVICTIONS.inc(float(evicted))
        return new

    def spans_for(self, trace_id: str) -> list[dict]:
        with self._lock:
            ids = self._by_trace.get(trace_id) or ()
            return [dict(self._spans[sid]) for sid in ids if sid in self._spans]

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._spans.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_trace.clear()


REMOTE_SPANS = RemoteSpanStore()


def configure(cfg) -> None:
    """The remote store's capacity from config (TPUMOUNTER_REMOTE_SPAN_CAPACITY)."""
    REMOTE_SPANS.capacity = cfg.remote_span_capacity


# --- assembly ---


def _attribute(span: dict, children: dict[str, list[dict]], lo: float, hi: float,
               acc: dict[str, float]) -> None:
    """Charge the window [lo, hi] that `span` owns: uncovered time to its
    own phase, covered time recursively to the covering child. Siblings go
    in start order and a later one's overlap with an earlier one is
    skipped, so every instant is charged once and sum(acc) == hi - lo.
    Child windows are clipped to the parent's (two processes' wall clocks
    drift). A child that starts at or past `hi` (its parent clipped, or
    the clocks drifted) ends the walk before any gap is charged: the
    reference charges the gap to `hi` there and again after the loop."""
    phase = phase_of(span.get("name", ""))
    cursor = lo
    kids = sorted(children.get(span.get("span_id", ""), []), key=lambda s: s.get("start", 0.0))
    for kid in kids:
        k_lo = max(cursor, float(kid.get("start", 0.0)))
        k_hi = min(hi, float(kid.get("start", 0.0)) + float(kid.get("duration_s", 0.0)))
        if k_hi <= cursor:
            continue  # inside an earlier sibling's window
        if k_lo >= hi:
            break
        if k_lo > cursor:
            acc[phase] = acc.get(phase, 0.0) + (k_lo - cursor)
        _attribute(kid, children, k_lo, k_hi, acc)
        cursor = k_hi
    if cursor < hi:
        acc[phase] = acc.get(phase, 0.0) + (hi - cursor)


def _waterfall(roots: list[dict], children: dict[str, list[dict]],
               origin: float) -> list[dict]:
    out: list[dict] = []

    def walk(span: dict, depth: int) -> None:
        out.append({**span, "depth": depth,
                    "offset_ms": round((float(span.get("start", origin)) - origin) * 1000.0, 3),
                    "phase": phase_of(span.get("name", ""))})
        for kid in sorted(children.get(span.get("span_id", ""), []),
                          key=lambda s: s.get("start", 0.0)):
            walk(kid, depth + 1)

    for root in sorted(roots, key=lambda s: s.get("start", 0.0)):
        walk(root, 0)
    return out


def assemble(trace_id: str, tracer=None, remote=None) -> dict | None:
    """One trace's story across daemons: the local ring joined with the
    federated spans (local wins a span-id collision, keeping the remote
    copy's node), the tree, and the wall time by phase. None when nothing
    is buffered for the id; else a payload that also says how complete the
    assembly is: ``orphans`` (spans whose parent never arrived) and
    ``missing_worker_halves`` (successful rpc.* spans without a worker.*
    child) are the two ways a distributed trace lies."""
    local = (tracer or trace.TRACER).ring.spans_for(trace_id)
    remote_store = REMOTE_SPANS if remote is None else remote
    merged: dict[str, dict] = {}
    for span in remote_store.spans_for(trace_id):
        if span.get("span_id"):
            merged[span["span_id"]] = span
    for span in local:
        sid = span.get("span_id")
        if sid:
            merged[sid] = {**(merged.get(sid) or {}), **span}
    if not merged:
        return None

    spans = sorted(merged.values(), key=lambda s: (s.get("start", 0.0), s.get("span_id", "")))
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    orphans: list[dict] = []
    for span in spans:
        parent_id = span.get("parent_id") or ""
        if not parent_id:
            roots.append(span)
        elif parent_id in merged:
            children.setdefault(parent_id, []).append(span)
        else:
            orphans.append(span)

    missing_halves: list[str] = []
    for span in spans:
        name = span.get("name", "")
        if not name.startswith("rpc.") or name in _RPC_NO_WORKER_HALF:
            continue
        if span.get("status") != "ok":
            continue  # the call failed: there may be no worker half
        kids = children.get(span.get("span_id", ""), [])
        if not any(k.get("name", "").startswith("worker.") for k in kids):
            missing_halves.append(span.get("span_id", ""))

    phases: dict[str, float] = {}
    wall_s = 0.0
    primary = None
    for root in roots:
        lo = float(root.get("start", 0.0))
        _attribute(root, children, lo, lo + float(root.get("duration_s", 0.0)), phases)
        wall_s += float(root.get("duration_s", 0.0))
        if primary is None or root.get("duration_s", 0.0) > primary.get("duration_s", 0.0):
            primary = root
    origin = spans[0].get("start", 0.0)

    phase_ms = {p: round(s * 1000.0, 3) for p, s in phases.items()}
    total_ms = sum(phase_ms.values())
    critical_path = sorted(
        ({"phase": p, "ms": ms, "share": round(ms / total_ms, 4) if total_ms else 0.0}
         for p, ms in phase_ms.items()),
        key=lambda e: -e["ms"])
    return {
        "trace": trace_id,
        "op": (primary or {}).get("name", ""),
        "wall_ms": round(wall_s * 1000.0, 3),
        # an orphans-only trace (the local half expired) still renders
        "spans": _waterfall(roots + orphans, children, origin),
        "roots": len(roots),
        "nodes": sorted({s.get("node", "") for s in spans if s.get("node")}),
        "phases": phase_ms,
        "critical_path": critical_path,
        "dominant": critical_path[0] if critical_path else None,
        "complete": not orphans and not missing_halves,
        "orphans": [s.get("span_id", "") for s in orphans],
        "missing_worker_halves": missing_halves,
    }


#: edge span names of mount-shaped operations: fleet_dominant_phase's
#: population
MOUNT_EDGE_PREFIXES = ("http.add", "http.batch_add", "http.remove", "chaos.",
                       "worker.AddGPU", "worker.RemoveGPU")


def fleet_dominant_phase(tracer=None, remote=None, limit: int = 32) -> dict | None:
    """The phase that took most of the newest `limit` mount-shaped traces'
    wall time: {"phase", "ms", "share", "traces"}, or None. A worker edge
    span counts as a root only where the master's http edge is absent (a
    worker evaluating alone)."""
    ring = (tracer or trace.TRACER).ring.snapshot()
    trace_ids: list[str] = []
    for span in reversed(ring):
        if span.get("parent_id"):
            continue
        name = span.get("name", "")
        if not any(name.startswith(p) for p in MOUNT_EDGE_PREFIXES):
            continue
        tid = span.get("trace_id", "")
        if tid and tid not in trace_ids:
            trace_ids.append(tid)
        if len(trace_ids) >= limit:
            break
    if not trace_ids:
        return None
    acc: dict[str, float] = {}
    assembled = 0
    for tid in trace_ids:
        tree = assemble(tid, tracer=tracer, remote=remote)
        if tree is None:
            continue
        assembled += 1
        for phase, ms in tree["phases"].items():
            acc[phase] = acc.get(phase, 0.0) + ms
    if not acc:
        return None
    total = sum(acc.values())
    dominant = max(acc, key=lambda p: acc[p])
    return {"phase": dominant, "ms": round(acc[dominant], 3),
            "share": round(acc[dominant] / total, 4) if total else 0.0,
            "traces": assembled}
