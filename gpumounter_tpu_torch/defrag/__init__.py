"""The defragmenter: capacity recovered through live migration.

The capacity plane (``obs/capacity.py``) says a shape is
``admissible-after-defrag``; this package acts on it. The planner
(``planner.py``) turns a capacity snapshot into the fewest, cheapest tenant
moves, in the NVSwitch form; the controller (``controller.py``) drives them
through the migration machine (``migrate/orchestrator.py``) with the
checkpoint-assisted drain, gated on the tenants' SLO burn and ApiHealth, and
stamps ``capacity.recovered`` when a run moved anything. Served at GET
/defrag and POST /defrag/plan, /defrag/run and /defrag/pause.
"""

from gpumounter_tpu_torch.defrag.controller import (
    ANNOT_DEFRAG_DEST,
    DefragController,
    DefragRefused,
)
from gpumounter_tpu_torch.defrag.planner import (
    PlanError,
    fleet_fragmentation_index,
    parse_hosts,
    plan_moves,
)

__all__ = [
    "ANNOT_DEFRAG_DEST",
    "DefragController",
    "DefragRefused",
    "PlanError",
    "fleet_fragmentation_index",
    "parse_hosts",
    "plan_moves",
]
