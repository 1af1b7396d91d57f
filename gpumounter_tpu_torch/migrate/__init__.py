"""Live migration: the journal kept as an annotation on the source pod
(``journal.py``) and the machine that drains, moves and resumes a tenant's
GPUs (``orchestrator.py``)."""

from gpumounter_tpu_torch.migrate.journal import (
    ANNOT_ACK,
    ANNOT_JOURNAL,
    ANNOT_LOCK,
    ANNOT_PHASE,
    PHASE_DONE,
    PHASES,
    migration_active,
    new_journal,
    parse_journal,
)
from gpumounter_tpu_torch.migrate.orchestrator import (
    MigrationCoordinator,
    MigrationError,
    MigrationRejected,
)

__all__ = [
    "ANNOT_ACK",
    "ANNOT_JOURNAL",
    "ANNOT_LOCK",
    "ANNOT_PHASE",
    "MigrationCoordinator",
    "MigrationError",
    "MigrationRejected",
    "PHASES",
    "PHASE_DONE",
    "migration_active",
    "new_journal",
    "parse_journal",
]
