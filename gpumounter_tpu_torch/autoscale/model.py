"""A tenant's batch size -> tokens/s curve, learned from its telemetry.

The counterpart of ``gpumounter_tpu/autoscale/model.py``. The controller
scales along a measured saturating curve

    rate(b) = r_max * b / (b + b_half)

rather than on queue depth alone: a tenant that is queue-deep because its
batch is tiny would idle more GPUs, and one briefly quiet at full saturation
would meet the next wave on half the slice. The tenants' snapshots
(``torchside/telemetry.py``) carry cumulative step and token counters, not a
batch size, so each observation is the delta of two consecutive snapshots:
batch = d_tokens / d_steps (the tokens of one step), paired with the
snapshot's published tokens_per_s.

The fit is the least squares of the double-reciprocal form (1/r against
1/b): standard library, linear in the history. What matters more than its
quality is the refusal: a tenant with fewer than ``autoscale_min_samples``
observations is ``sparse``, one whose newest sample is older than
``autoscale_stale_s`` is ``stale``, and the controller acts on neither.

The history is bounded a tenant (``autoscale_history``) and the tenant table
too (``autoscale_max_tenants``): a churning namespace cannot grow the
model, and no tenant name becomes a metric label.
"""

from __future__ import annotations

import time
from collections import deque

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("autoscale.model")

#: the fit's verdicts
VERDICTS = ("ok", "sparse", "stale", "untracked")


def _plateau(pts: list[tuple[float, float]]) -> dict:
    """The mean rate as the plateau (b_half 0: rate == r_max at any batch)."""
    return {"r_max": sum(r for _, r in pts) / float(len(pts)), "b_half": 0.0, "rmse": 0.0,
            "plateau_only": True}


def fit_curve(samples: list[tuple[float, float]]) -> dict | None:
    """Least squares of rate = r_max * b / (b + b_half) over (batch, rate)
    pairs through 1/r = (b_half / r_max) * (1/b) + 1/r_max. Returns {r_max,
    b_half, rmse, plateau_only}, or None with fewer than two positive
    pairs. One distinct batch (no slope) or a non-positive intercept (noise
    broke the linearization) gives the mean-rate plateau instead."""
    pts = [(b, r) for b, r in samples if b > 0 and r > 0]
    if len(pts) < 2:
        return None
    xs = [1.0 / b for b, _ in pts]
    ys = [1.0 / r for _, r in pts]
    n = float(len(pts))
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    var_x = sum((x - mean_x) ** 2 for x in xs)
    if var_x <= 1e-12:
        return _plateau(pts)
    slope = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, ys)) / var_x
    intercept = mean_y - slope * mean_x
    if intercept <= 1e-12:
        return _plateau(pts)
    r_max = 1.0 / intercept
    b_half = max(0.0, slope * r_max)
    err = 0.0
    for b, r in pts:
        pred = r_max * b / (b + b_half) if (b + b_half) > 0 else 0.0
        err += (pred - r) ** 2
    return {"r_max": r_max, "b_half": b_half, "rmse": (err / n) ** 0.5, "plateau_only": False}


def predict(fit: dict, batch: float) -> float:
    """The modelled tokens/s at a batch size, from a ``fit_curve`` result."""
    b_half = float(fit.get("b_half", 0.0))
    r_max = float(fit.get("r_max", 0.0))
    if batch <= 0 or (batch + b_half) <= 0:
        return 0.0
    return r_max * batch / (batch + b_half)


class ThroughputModel:
    """The tenants' bounded observations and the fit the controller reads.
    One a master, in memory: it learns again from live telemetry within a
    few passes of a restart."""

    def __init__(self, cfg=None, clock=None):
        self.cfg = cfg or Config()
        #: the diurnal sim drives simulated time through it
        self.clock = clock or time.time
        self._lock = OrderedLock("autoscale.model")
        #: tenant -> deque[(at, batch, tokens_per_s)]
        self._samples: dict[str, deque] = {}
        #: tenant -> the last cumulative snapshot, the delta's base
        self._last: dict[str, dict] = {}
        #: tenants refused by the table's bound (a count, never names)
        self.overflow_dropped = 0

    # --- ingestion ---

    def observe(self, tenant: str, snapshot: dict) -> tuple | None:
        """Fold one /tenants snapshot in. Returns the derived (at, batch,
        tokens_per_s), or None when it yields no delta: the first sighting,
        no step progress, a counter reset (re-baselined, never
        extrapolated), or a full table."""
        steps = snapshot.get("steps") or {}
        count = float(steps.get("count") or 0.0)
        tokens = float(snapshot.get("tokens_total") or 0.0)
        at = float(snapshot.get("at") or 0.0)
        rate = float(snapshot.get("tokens_per_s") or 0.0)
        with self._lock:
            prev = self._last.get(tenant)
            if prev is None and tenant not in self._samples:
                if len(self._samples) >= int(self.cfg.autoscale_max_tenants):
                    self.overflow_dropped += 1
                    return None
                self._samples[tenant] = deque(maxlen=max(2, int(self.cfg.autoscale_history)))
            self._last[tenant] = {"count": count, "tokens": tokens, "at": at}
            if prev is None:
                return None
            d_steps = count - prev["count"]
            d_tokens = tokens - prev["tokens"]
            if d_steps <= 0 or d_tokens <= 0 or at <= prev["at"]:
                return None
            batch = d_tokens / d_steps
            if rate <= 0.0:
                rate = d_tokens / max(1e-9, at - prev["at"])
            sample = (at, batch, rate)
            self._samples[tenant].append(sample)
            return sample

    def observe_nodes(self, nodes: dict) -> int:
        """The fleet collector's ``throughput`` observer: fold every tenant
        snapshot of a fresh node map. Returns the samples derived; never
        raises (the model is advisory)."""
        derived = 0
        try:
            from gpumounter_tpu_torch.obs.fleet import merge_tenants
            for tenant, snap in merge_tenants(nodes).items():
                if self.observe(tenant, snap) is not None:
                    derived += 1
        except Exception:  # noqa: BLE001 — an observer never fails telemetry
            logger.exception("throughput observation failed")
        return derived

    def forget(self, tenant: str) -> None:
        with self._lock:
            self._samples.pop(tenant, None)
            self._last.pop(tenant, None)

    # --- fitting ---

    def fit(self, tenant: str, now: float | None = None) -> dict:
        """The tenant's curve and whether it may be acted on: always a dict
        with a ``verdict`` of VERDICTS, the curve's parameters only when
        ``ok``, with the utilization (the last rate over the plateau; at 1.0
        more queue wants more GPUs, not bigger batches)."""
        now = self.clock() if now is None else now
        with self._lock:
            samples = list(self._samples.get(tenant) or ())
        out: dict = {"tenant": tenant, "samples": len(samples)}
        if tenant not in self._samples:
            out["verdict"] = "untracked"
            return out
        if len(samples) < int(self.cfg.autoscale_min_samples):
            out["verdict"] = "sparse"
            return out
        age = now - max(at for at, _, _ in samples)
        out["newest_age_s"] = round(age, 3)
        if age > float(self.cfg.autoscale_stale_s):
            out["verdict"] = "stale"
            return out
        curve = fit_curve([(b, r) for _, b, r in samples])
        if curve is None:
            out["verdict"] = "sparse"
            return out
        out["verdict"] = "ok"
        out.update(r_max=round(curve["r_max"], 3), b_half=round(curve["b_half"], 3),
                   rmse=round(curve["rmse"], 3), plateau_only=curve["plateau_only"])
        _, last_batch, last_rate = samples[-1]
        out["last_batch"] = round(last_batch, 3)
        out["last_rate"] = round(last_rate, 3)
        out["utilization"] = (round(min(2.0, last_rate / curve["r_max"]), 3)
                              if curve["r_max"] > 0 else 0.0)
        return out

    # --- surfaces ---

    def payload(self, now: float | None = None) -> dict:
        """The model's half of GET /autoscale: each tracked tenant's fit and
        the overflow count."""
        with self._lock:
            tenants = sorted(self._samples)
        return {"tenants": {t: self.fit(t, now=now) for t in tenants},
                "tracked": len(tenants), "overflow_dropped": self.overflow_dropped}
