"""The master's recovery plane: find dead nodes and evacuate them
(``controller.py``), served at GET /recovery and
POST /recovery/evacuate/<node>."""

from gpumounter_tpu_torch.recovery.controller import RecoveryController

__all__ = ["RecoveryController"]
