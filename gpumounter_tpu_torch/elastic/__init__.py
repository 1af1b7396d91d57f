"""Elastic intents: a pod's declared GPU count, kept as annotations on it
(``intents.py``), the rate-limited work queue with a backoff a key
(``workqueue.py``), and the reconciler that converges and heals
(``reconciler.py``)."""

from gpumounter_tpu_torch.elastic.intents import (
    ANNOT_DESIRED,
    ANNOT_MIN,
    ANNOT_PRIORITY,
    ANNOT_REPLACED,
    Intent,
    IntentError,
    IntentStore,
)
from gpumounter_tpu_torch.elastic.reconciler import ElasticReconciler, ReconcileError
from gpumounter_tpu_torch.elastic.workqueue import BackoffPolicy, RateLimitedQueue

__all__ = [
    "ANNOT_DESIRED",
    "ANNOT_MIN",
    "ANNOT_PRIORITY",
    "ANNOT_REPLACED",
    "BackoffPolicy",
    "ElasticReconciler",
    "Intent",
    "IntentError",
    "IntentStore",
    "RateLimitedQueue",
    "ReconcileError",
]
