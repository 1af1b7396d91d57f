"""The autoscaler: tenant telemetry in, elastic intents out.

The counterpart of ``gpumounter_tpu/autoscale/``. Two halves: a tenant's
batch size -> tokens/s model (``model.py``: a bounded history, the stale and
sparse refusals) and the gated controller (``controller.py``: the SLO,
ApiHealth and quarantine guards, the capacity plane's verdicts in their
NVSwitch form, hysteresis and cooldowns, audited and traced decisions).
Served at GET /autoscale and POST /autoscale/pause, /autoscale/resume and
/autoscale/evaluate.
"""

from gpumounter_tpu_torch.autoscale.controller import (
    GATING_OBJECTIVES,
    SKIP_REASONS,
    AutoscaleController,
    AutoscaleRefused,
)
from gpumounter_tpu_torch.autoscale.model import (
    VERDICTS,
    ThroughputModel,
    fit_curve,
    predict,
)

__all__ = [
    "AutoscaleController",
    "AutoscaleRefused",
    "GATING_OBJECTIVES",
    "SKIP_REASONS",
    "ThroughputModel",
    "VERDICTS",
    "fit_curve",
    "predict",
]
