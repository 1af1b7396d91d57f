"""Failpoints: named fault-injection sites (see ``faults/failpoints.py``).

The counterpart of ``gpumounter_tpu/faults/``; the sites the port declares
are in ``faults/registry.py``."""

from gpumounter_tpu_torch.faults.failpoints import (
    ENV_VAR,
    CrashError,
    FailpointError,
    FailpointSpecError,
    InjectedUnavailable,
    Registry,
    active,
    arm,
    arm_spec,
    armed,
    disarm,
    disarm_all,
    fire,
    hits,
    is_armed,
    seed,
    value,
)

__all__ = [
    "ENV_VAR",
    "CrashError",
    "FailpointError",
    "FailpointSpecError",
    "InjectedUnavailable",
    "Registry",
    "active",
    "arm",
    "arm_spec",
    "armed",
    "disarm",
    "disarm_all",
    "fire",
    "hits",
    "is_armed",
    "seed",
    "value",
]
