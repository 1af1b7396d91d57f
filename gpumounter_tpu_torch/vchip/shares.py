"""The master's share books: who holds what share of which GPU.

The counterpart of ``gpumounter_tpu/vchip/shares.py``. The registry stores
and indexes; the packer (``packer.py``) decides who may take a share, and
the cgroup layer enforces what a share may do. It guarantees:

  * at most vchip_max_shares shares (a runaway client cannot grow them);
  * each GPU's load (its weights' sum), for the packer's
    ``load + weight <= vchip_weight_capacity``;
  * ``books()``: tenant -> {GPU uuid: (weight, rate budget)}, the packed
    shape of the policy entries and the ledger's share records, which chaos
    invariant 19 compares with both.

A share's id is ``<namespace>/<pod>/<uuid>``; booking the same (tenant,
GPU) again is a re-grant in place, as the enforcement's map write is, and
takes no new slot. The series are the fleet's only (no tenant or GPU
label); the detail is GET /shares. The names, the JSON keys and the schema
``tpumounter-shares/1`` are the reference's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("vchip.shares")

SHARES_SCHEMA = "tpumounter-shares/1"

SHARES_ACTIVE = REGISTRY.gauge(
    "tpumounter_vchip_shares_active",
    "Fractional chip shares currently on the books")
SHARED_CHIPS = REGISTRY.gauge(
    "tpumounter_vchip_shared_chips",
    "Physical chips currently split across more than one tenant")
SHARE_ADMITS = REGISTRY.counter(
    "tpumounter_vchip_share_admits_total",
    "Shares admitted onto the books (re-grants of an existing "
    "(tenant, chip) share count too — they are the O(1) warm path)")
SHARE_RELEASES = REGISTRY.counter(
    "tpumounter_vchip_share_releases_total",
    "Shares released from the books")


class ShareLimitError(RuntimeError):
    """The books are full (vchip_max_shares)."""


@dataclass(frozen=True)
class Share:
    """One tenant's share of one GPU."""
    namespace: str
    pod: str
    chip_uuid: str
    node: str
    weight: int
    rate_budget: int  # 0: unmetered
    profile: str      # "prefill", "decode", "balanced" or any other
    created_at: float = field(default_factory=time.time)

    @property
    def tenant(self) -> str:
        return f"{self.namespace}/{self.pod}"

    @property
    def share_id(self) -> str:
        return f"{self.namespace}/{self.pod}/{self.chip_uuid}"

    def to_json(self) -> dict:
        return {
            "tenant": self.tenant,
            "namespace": self.namespace,
            "pod": self.pod,
            "chip_uuid": self.chip_uuid,
            "node": self.node,
            "weight": self.weight,
            "rate_budget": self.rate_budget,
            "profile": self.profile,
            "created_at": round(self.created_at, 3),
        }


class ShareRegistry:
    def __init__(self, cfg=None):
        if cfg is None:
            from gpumounter_tpu_torch.config import Config
            cfg = Config()
        self.cfg = cfg
        self._lock = OrderedLock("vchip.shares")
        self._shares: dict[str, Share] = {}
        self._by_chip: dict[str, set[str]] = {}

    # --- changes ---

    def add(self, share: Share) -> Share:
        """Book a share; the same (tenant, GPU) again replaces it in place
        and takes no new slot. Raises ShareLimitError when the books are
        full."""
        with self._lock:
            sid = share.share_id
            if sid not in self._shares and len(self._shares) >= int(self.cfg.vchip_max_shares):
                raise ShareLimitError(f"share books full ({self.cfg.vchip_max_shares}); "
                                      f"refusing {sid}")
            self._shares[sid] = share
            self._by_chip.setdefault(share.chip_uuid, set()).add(sid)
            self._update_gauges_locked()
        SHARE_ADMITS.inc()
        return share

    def remove(self, namespace: str, pod: str, chip_uuid: str) -> bool:
        with self._lock:
            removed = self._remove_locked(f"{namespace}/{pod}/{chip_uuid}")
            self._update_gauges_locked()
        if removed:
            SHARE_RELEASES.inc()
        return removed

    def remove_tenant(self, namespace: str, pod: str) -> list[Share]:
        """Every share of a tenant off the books; returns them, so that the
        caller clears their policy entries."""
        prefix = f"{namespace}/{pod}/"
        with self._lock:
            victims = [s for sid, s in self._shares.items() if sid.startswith(prefix)]
            for share in victims:
                self._remove_locked(share.share_id)
            self._update_gauges_locked()
        if victims:
            SHARE_RELEASES.inc(float(len(victims)))
        return victims

    def _remove_locked(self, sid: str) -> bool:
        share = self._shares.pop(sid, None)
        if share is None:
            return False
        holders = self._by_chip.get(share.chip_uuid)
        if holders is not None:
            holders.discard(sid)
            if not holders:
                self._by_chip.pop(share.chip_uuid, None)
        return True

    def _update_gauges_locked(self) -> None:
        SHARES_ACTIVE.set(float(len(self._shares)))
        SHARED_CHIPS.set(float(sum(1 for sids in self._by_chip.values() if len(sids) > 1)))

    # --- reads ---

    def get(self, namespace: str, pod: str, chip_uuid: str) -> Share | None:
        with self._lock:
            return self._shares.get(f"{namespace}/{pod}/{chip_uuid}")

    def by_chip(self, chip_uuid: str) -> list[Share]:
        with self._lock:
            return [self._shares[sid] for sid in sorted(self._by_chip.get(chip_uuid, ()))]

    def by_tenant(self, namespace: str, pod: str) -> list[Share]:
        prefix = f"{namespace}/{pod}/"
        with self._lock:
            return [s for sid, s in sorted(self._shares.items()) if sid.startswith(prefix)]

    def chip_load(self, chip_uuid: str) -> int:
        """The weights booked on a GPU."""
        with self._lock:
            return sum(self._shares[sid].weight for sid in self._by_chip.get(chip_uuid, ()))

    def shared_chips(self) -> dict[str, list[Share]]:
        """GPU uuid -> its shares, for every GPU on the books."""
        with self._lock:
            return {uuid: [self._shares[sid] for sid in sorted(sids)]
                    for uuid, sids in sorted(self._by_chip.items())}

    def books(self) -> dict[str, dict[str, tuple[int, int]]]:
        """tenant -> {GPU uuid: (weight, rate budget)}: invariant 19's view."""
        out: dict[str, dict[str, tuple[int, int]]] = {}
        with self._lock:
            for share in self._shares.values():
                out.setdefault(share.tenant, {})[share.chip_uuid] = (share.weight,
                                                                      share.rate_budget)
        return out

    def payload(self) -> dict:
        """The GET /shares body."""
        capacity = int(self.cfg.vchip_weight_capacity)
        with self._lock:
            shares = [self._shares[sid].to_json() for sid in sorted(self._shares)]
            chips = {}
            for uuid, sids in sorted(self._by_chip.items()):
                ordered = sorted(sids)
                load = sum(self._shares[sid].weight for sid in ordered)
                chips[uuid] = {
                    "node": self._shares[ordered[0]].node,
                    "tenants": len(ordered),
                    "load": load,
                    "headroom": max(0, capacity - load),
                    "profiles": sorted({self._shares[sid].profile for sid in ordered}),
                }
        return {
            "schema": SHARES_SCHEMA,
            "at": time.time(),
            "weight_capacity": capacity,
            "max_shares": int(self.cfg.vchip_max_shares),
            "shares": shares,
            "chips": chips,
            "totals": {
                "shares": len(shares),
                "chips": len(chips),
                "shared_chips": sum(1 for c in chips.values() if c["tenants"] > 1),
            },
        }
