"""The gray-failure health plane: the scorer and the quarantine state
machine over the fleet collector's passes, and the canary prober
(``plane.py``), served at GET /health/nodes and
POST /health/quarantine/<node>."""

from gpumounter_tpu_torch.health.plane import STATES, CanaryProber, HealthPlane

__all__ = ["STATES", "CanaryProber", "HealthPlane"]
