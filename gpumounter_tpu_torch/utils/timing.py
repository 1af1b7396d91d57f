"""Per-phase latency of one mount or unmount.

The counterpart of ``gpumounter_tpu/utils/timing.py``. Hot-mount latency is
what a user of this system waits for, so every flow records its phases
(slave-pod schedule, cgroup grant, device inject, ...) and returns them in
its result.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    """Accumulates named phase durations for one operation."""

    phases: dict[str, float] = field(default_factory=dict)
    _start: float = field(default_factory=time.monotonic)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.monotonic() - t0)

    def total(self) -> float:
        return time.monotonic() - self._start

    def summary_ms(self) -> dict[str, float]:
        out = {k: v * 1000.0 for k, v in self.phases.items()}
        out["total"] = self.total() * 1000.0
        return out
