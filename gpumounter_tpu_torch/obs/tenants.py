"""The worker's store of tenant telemetry snapshots.

The counterpart of ``gpumounter_tpu/obs/tenants.py``, whole. Tenants
(``torchside/telemetry.py``'s ``TenantTelemetry``) POST cumulative snapshots
to the worker's ops port (/tenant-telemetry, mutate scope). This store keeps
the latest snapshot a tenant, bounded by the same 256 + ``_overflow``
convention as the device-access table (``cgroup/ebpf.py``): tenant names
come from pod names, which users choose, so past ``max_tenants`` distinct
tenants the later ones fold into one ``_overflow`` entry (the latest
snapshot wins, with a count of how many were folded), and neither the
worker's memory nor the fleet payload can grow without bound.

The worker's CollectTelemetry snapshot carries ``export()`` under its
"tenants" key, and the master's ``FleetCollector`` merges those across the
fleet (``obs/fleet.py``). Values stay cumulative end to end, so the rule of
no double counting (chaos invariant 8) holds for tenant series too.
Standard library only.
"""

from __future__ import annotations

import json
import time

from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("obs.tenants")

TENANT_SCHEMA = "tpumounter-tenant/1"
OVERFLOW_TENANT = "_overflow"

TENANT_SNAPSHOTS = REGISTRY.counter(
    "tpumounter_tenant_snapshots_total",
    "Tenant telemetry snapshots accepted on the ops port (no tenant "
    "label by design — per-tenant series live in the JSON plane, "
    "bounded by the store's 256 + _overflow cap)")
TENANT_SNAPSHOTS_REJECTED = REGISTRY.counter(
    "tpumounter_tenant_snapshots_rejected_total",
    "Tenant telemetry POSTs rejected (bad schema / malformed JSON)")
TENANTS_TRACKED = REGISTRY.gauge(
    "tpumounter_tenants_tracked",
    "Distinct tenants with a stored snapshot (overflow bucket counts "
    "as one)")


def parse_tenant_snapshot(raw: object) -> dict | None:
    """A POST body as a snapshot, or None: anything but a JSON object with
    the schema tag and a non-empty tenant name (the ops port answers 400).
    Never raises."""
    if isinstance(raw, (bytes, bytearray)):
        try:
            raw = raw.decode()
        except UnicodeDecodeError:
            return None
    if not raw or not isinstance(raw, str):
        return None
    try:
        doc = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(doc, dict) or doc.get("schema") != TENANT_SCHEMA:
        return None
    if not doc.get("tenant") or not isinstance(doc["tenant"], str):
        return None
    return doc


class TenantStore:
    """The latest snapshot a tenant, capped at max_tenants + _overflow."""

    def __init__(self, max_tenants: int = 256):
        self.max_tenants = max_tenants
        self._lock = OrderedLock("tenants.store")
        self._snapshots: dict[str, dict] = {}
        self._received_at: dict[str, float] = {}
        self._overflow_folded: set[str] = set()

    def _key_for(self, tenant: str) -> str:
        if tenant in self._snapshots or len(self._snapshots) < self.max_tenants:
            return tenant
        return OVERFLOW_TENANT

    def ingest(self, snapshot: dict) -> str:
        """Store a parsed snapshot; returns the key it landed under (the
        tenant's name, or _overflow past the cap)."""
        tenant = snapshot["tenant"]
        with self._lock:
            key = self._key_for(tenant)
            if key == OVERFLOW_TENANT:
                self._overflow_folded.add(tenant)
                snapshot = {**snapshot, "tenant": OVERFLOW_TENANT,
                            "folded_tenants": len(self._overflow_folded)}
            self._snapshots[key] = snapshot
            self._received_at[key] = time.time()
            TENANTS_TRACKED.set(float(len(self._snapshots)))
        TENANT_SNAPSHOTS.inc()
        return key

    def export(self) -> dict[str, dict]:
        """tenant -> its latest snapshot with the worker's received_at stamp:
        the "tenants" block of the CollectTelemetry payload."""
        with self._lock:
            return {key: {**snap, "received_at": round(self._received_at[key], 3)}
                    for key, snap in self._snapshots.items()}

    def tenant_count(self) -> int:
        with self._lock:
            return len(self._snapshots)

    def reset(self) -> None:
        with self._lock:
            self._snapshots.clear()
            self._received_at.clear()
            self._overflow_folded.clear()
        TENANTS_TRACKED.set(0.0)


#: the worker process's store (one a daemon, as DEVICE_TELEMETRY; tests
#: build their own bounded ones)
TENANTS = TenantStore()
