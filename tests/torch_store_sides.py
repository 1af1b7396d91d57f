"""Both packages' store and degraded mode, as one namespace each.

A case of the store's tests is a function of a ``Side``: the reference's
(``gpumounter_tpu``) or the port's (``gpumounter_tpu_torch``) k8s errors,
fake client, ApiHealth, stores, write-behind queue, intents and journals,
under the same names. Each test runs its case on both and compares what
they return, with the reference's TPU read as GPU: the worker pods' label
and the pool namespace are each package's own, and the helpers here build
pods from the side's config. ``fresh(side, **changes)`` is the side's
Config with `changes`.
"""

from __future__ import annotations

import dataclasses
import types

from gpumounter_tpu import store as ref_store
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.elastic import intents as ref_intents
from gpumounter_tpu.k8s import client as ref_client
from gpumounter_tpu.k8s import errors as ref_errors
from gpumounter_tpu.k8s import fake as ref_fake
from gpumounter_tpu.k8s import health as ref_health
from gpumounter_tpu.k8s.types import Pod as RefPod
from gpumounter_tpu.migrate import journal as ref_journal
from gpumounter_tpu.store import writebehind as ref_writebehind
from gpumounter_tpu_torch import store as port_store
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.elastic import intents as port_intents
from gpumounter_tpu_torch.k8s import client as port_client
from gpumounter_tpu_torch.k8s import errors as port_errors
from gpumounter_tpu_torch.k8s import fake as port_fake
from gpumounter_tpu_torch.k8s import health as port_health
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.migrate import journal as port_journal
from gpumounter_tpu_torch.store import writebehind as port_writebehind


def _side(kind, config, client, errors, fake, health, store, writebehind, intents, journal,
          pod):
    return types.SimpleNamespace(
        kind=kind, Config=config, client=client, errors=errors, fake=fake,
        FakeKubeClient=fake.FakeKubeClient, health=health, ApiHealth=health.ApiHealth,
        Tracking=health.HealthTrackingKubeClient, store=store, writebehind=writebehind,
        Queue=writebehind.WriteBehindQueue, intents=intents, Intent=intents.Intent,
        journal=journal, Pod=pod)


SIDES = {
    "reference": _side("reference", RefConfig, ref_client, ref_errors, ref_fake, ref_health,
                       ref_store, ref_writebehind, ref_intents, ref_journal, RefPod),
    "port": _side("port", Config, port_client, port_errors, port_fake, port_health,
                  port_store, port_writebehind, port_intents, port_journal, Pod),
}


def fresh(side, **changes):
    return dataclasses.replace(side.Config(), **changes)


def worker_labels(cfg) -> dict[str, str]:
    key, _, value = cfg.worker_label_selector.partition("=")
    return {key: value}


def pod(kube, name, namespace="default", node="node-0", labels=None, annotations=None,
        ip="10.0.0.9") -> None:
    kube.create_pod(namespace, {
        "metadata": {"name": name, "namespace": namespace,
                     **({"labels": labels} if labels else {}),
                     **({"annotations": annotations} if annotations else {})},
        "spec": {"nodeName": node, "containers": [{"name": "c"}]},
        "status": {"phase": "Running", "podIP": ip}})


def worker_pod(kube, cfg, name="w1", node="n1", ip="10.0.0.1") -> None:
    pod(kube, name, cfg.worker_namespace, node, worker_labels(cfg), ip=ip)


def both(case, *args, **kwargs) -> dict:
    """{side name: case(side, *args, **kwargs)}."""
    return {name: case(side, *args, **kwargs) for name, side in SIDES.items()}
