"""Admission of fractional tenants: which GPUs should a tenant share?

The counterpart of ``gpumounter_tpu/vchip/packer.py``. A prefill-heavy
tenant is compute-bound in bursts, a decode-heavy one latency-bound and
steady: on one GPU with QoS weights the pair uses what whole-GPU grants
waste. ``SharePacker.admit`` ranks the candidates:

  1. shared GPUs whose tenants' profiles complement the request (prefill
     with decode) and whose load leaves room for its weight, the most
     loaded first, so that sharing concentrates;
  2. any other shared GPU with room;
  3. free GPUs, hosts on probation after the others, hosts the capacity
     plane names as blocked (a defragmentation needs them quiet) last;

a quarantined host (the health plane's ``excluded_hosts``) is never a
candidate, even when the refusal is the alternative. Too few candidates is
``PackRefused`` (the /shares route's 409), and the booking is all or
nothing. The packer decides and books; the caller pushes each share's
policy to the enforcement.
"""

from __future__ import annotations

from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.vchip.shares import Share, ShareRegistry

logger = get_logger("vchip.packer")

#: the profiles that pack well together
COMPLEMENTS = {"prefill": "decode", "decode": "prefill"}


class PackRefused(RuntimeError):
    """Bad arguments, or no set of GPUs with the weight's headroom."""


class SharePacker:
    def __init__(self, registry: ShareRegistry, cfg=None):
        if cfg is None:
            from gpumounter_tpu_torch.config import Config
            cfg = Config()
        self.cfg = cfg
        self.registry = registry

    def admit(self, namespace: str, pod: str, profile: str, chips: int, weight: int,
              rate_budget: int = 0, inventory: dict[str, str] | None = None,
              blocked_hosts: frozenset[str] | set[str] = frozenset(),
              excluded_hosts: frozenset[str] | set[str] = frozenset(),
              probation_hosts: frozenset[str] | set[str] = frozenset()) -> list[Share]:
        """Book `chips` shares of `weight` for namespace/pod.

        inventory: GPU uuid -> node for every GPU the caller may place on
        (the packer invents none; the shared GPUs are added from the books).
        blocked_hosts: last resort for free GPUs. excluded_hosts: never.
        probation_hosts: placeable, ranked after their equals. Returns the
        booked shares; a refusal books nothing."""
        capacity = int(self.cfg.vchip_weight_capacity)
        if chips <= 0:
            raise PackRefused(f"chips must be positive, got {chips}")
        if not 1 <= weight <= capacity:
            raise PackRefused(f"weight {weight} outside 1..{capacity} (vchip_weight_capacity)")
        if rate_budget < 0:
            raise PackRefused(f"rate_budget must be >= 0, got {rate_budget}")
        inventory = dict(inventory or {})
        shared = self.registry.shared_chips()
        held = {s.chip_uuid for s in self.registry.by_tenant(namespace, pod)}
        want = COMPLEMENTS.get(profile)

        complementary: list[tuple[int, int, str]] = []
        other_shared: list[tuple[int, int, str]] = []
        for uuid, holders in shared.items():
            if uuid in held:
                continue  # a re-grant books the same GPU again
            load = sum(s.weight for s in holders)
            if load + weight > capacity:
                continue
            node = holders[0].node
            if node in excluded_hosts:
                continue
            inventory.setdefault(uuid, node)
            profiles = {s.profile for s in holders}
            # probation last within its class, then the most loaded first
            key = (1 if node in probation_hosts else 0, -load, uuid)
            if want is not None and want in profiles and profile not in profiles:
                complementary.append(key)
            else:
                other_shared.append(key)
        taken = held | set(shared)
        placeable = {u: node for u, node in inventory.items() if node not in excluded_hosts}
        free_clear = sorted(u for u, node in placeable.items() if u not in taken
                            and node not in blocked_hosts and node not in probation_hosts)
        free_probation = sorted(u for u, node in placeable.items() if u not in taken
                                and node not in blocked_hosts and node in probation_hosts)
        free_blocked = sorted(u for u, node in placeable.items()
                              if u not in taken and node in blocked_hosts)
        ranked = ([u for *_, u in sorted(complementary)] + [u for *_, u in sorted(other_shared)]
                  + free_clear + free_probation + free_blocked)
        if len(ranked) < chips:
            raise PackRefused(
                f"need {chips} chip(s) with weight headroom {weight}, only {len(ranked)} "
                f"available (shared with room: {len(complementary) + len(other_shared)}, "
                f"free: {len(free_clear) + len(free_probation) + len(free_blocked)})")
        chosen = ranked[:chips]
        booked: list[Share] = []
        try:
            for uuid in chosen:
                booked.append(self.registry.add(Share(
                    namespace=namespace, pod=pod, chip_uuid=uuid, node=inventory[uuid],
                    weight=weight, rate_budget=rate_budget, profile=profile)))
        except Exception:
            for share in booked:
                self.registry.remove(share.namespace, share.pod, share.chip_uuid)
            raise
        n_coloc = sum(1 for u in chosen if u in shared)
        logger.info("admitted %d share(s) for %s/%s (profile=%s weight=%d budget=%d): %d "
                    "co-located, %d fresh%s", chips, namespace, pod, profile, weight,
                    rate_budget, n_coloc, chips - n_coloc,
                    " [used defrag-blocked hosts]" if any(u in free_blocked for u in chosen)
                    else "")
        return booked

    def release(self, namespace: str, pod: str) -> list[Share]:
        """Every share of a tenant off the books; returns them."""
        return self.registry.remove_tenant(namespace, pod)
