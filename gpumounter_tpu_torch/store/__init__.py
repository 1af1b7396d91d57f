"""The master's state store: the seam every replica rebuilds its view from.

The counterpart of ``gpumounter_tpu/store/``. ``MasterStore`` (base.py) is
the master's whole durable state: the worker registry, intents, migration
journals, pool pods, the health state and annotation stamps.
``KubeMasterStore`` (k8s.py) keeps it on the cluster's objects, and
``WatchMasterStore`` (watch.py) serves it from indexes a watch keeps.
``CachedMasterStore`` (cache.py) wraps either with the API-outage degraded
mode: reads from a bounded-staleness cache, and annotation writes deferred
into the fsync'd ``WriteBehindQueue`` (writebehind.py), replayed once each
when the API heals.
"""

from gpumounter_tpu_torch.store.base import MasterStore
from gpumounter_tpu_torch.store.cache import CachedMasterStore
from gpumounter_tpu_torch.store.k8s import KubeMasterStore
from gpumounter_tpu_torch.store.watch import WatchMasterStore
from gpumounter_tpu_torch.store.writebehind import WriteBehindQueue

__all__ = ["MasterStore", "KubeMasterStore", "CachedMasterStore", "WatchMasterStore",
           "WriteBehindQueue"]
