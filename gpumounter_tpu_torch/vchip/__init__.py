"""Fractional GPU shares: one GPU, held by one slave pod, split among
tenants, each with a QoS weight and a token budget.

``shares.py`` holds the master's books (``ShareRegistry``: who holds what
share of which GPU, served at GET /shares, and the ``books()`` view chaos
invariant 19 compares with the policy entries and the worker's ledger);
``packer.py`` the admission (``SharePacker``: complementary tenants on
shared GPUs first, then free ones, blocked hosts last, quarantined hosts
never). The enforcement is the cgroup layer's: the policy map of
``cgroup/ebpf.py`` where the kernel has one, the userspace engine of
``cgroup/policy.py`` elsewhere.
"""

from gpumounter_tpu_torch.vchip.packer import COMPLEMENTS, PackRefused, SharePacker
from gpumounter_tpu_torch.vchip.shares import (
    SHARES_SCHEMA,
    Share,
    ShareLimitError,
    ShareRegistry,
)

__all__ = ["COMPLEMENTS", "PackRefused", "SHARES_SCHEMA", "Share", "ShareLimitError",
           "SharePacker", "ShareRegistry"]
