"""The port's warm pool (``gpumounter_tpu_torch/allocator/pool.py``) and the
allocator's warm fast path.

Held to ``tests/test_warm_pool.py`` and to
``tests/test_api_outage.py::test_warm_pool_refill_backs_off_during_outage``:
each scenario runs on the reference's fake cluster with its ``TpuAllocator``
and ``WarmPodPool``, and on the port's with ``GpuAllocator`` and its pool,
both pools in the deterministic mode (``refill_async=False``), and what each
observed (adoptions, hits and misses, ready counts, the pods the API holds,
creates) must be equal. Then the worker's wiring: a service built with
WARM_POOL_SIZE draws from its pool, and the add's span says so.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.allocator import pool as ref_pool_mod
from gpumounter_tpu.allocator.allocator import TpuAllocator
from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu_torch.allocator import pool as pool_mod
from gpumounter_tpu_torch.allocator.allocator import GpuAllocator
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.testing.cluster import FakeCluster

N = 4


class _Side:
    """One package's cluster, allocator and pool of `size`."""

    def __init__(self, kind, root, size, **cfg):
        self.kind = kind
        if kind == "reference":
            self.mod, self.fp = ref_pool_mod, ref_failpoints
            self.cluster = RefCluster(str(root / "ref"), n_chips=N).start()
            self.cfg = self.cluster.cfg.replace(warm_pool_size=size, **cfg)
            collector = TpuCollector(backend=self.cluster.backend, podresources=PodResourcesClient(
                self.cfg.kubelet_socket, timeout_s=5.0), cfg=self.cfg)
            self.pool = self.mod.WarmPodPool(self.cluster.kube, cfg=self.cfg, refill_async=False)
            self.allocator = TpuAllocator(self.cluster.kube, collector, cfg=self.cfg,
                                          pool=self.pool)
            self.get = self.allocator.get_available_tpus
            self.resource = self.cfg.tpu_resource_name
        else:
            self.mod, self.fp = pool_mod, failpoints
            self.cluster = FakeCluster.with_fake_gpus(str(root / "port"), N)
            self.cfg = dataclasses.replace(self.cluster.cfg, warm_pool_size=size, **cfg)
            collector = GpuCollector(self.cluster.backend, self.cluster.kubelet, cfg=self.cfg)
            self.pool = self.mod.WarmPodPool(self.cluster.kube, cfg=self.cfg, refill_async=False)
            self.allocator = GpuAllocator(self.cluster.kube, collector, cfg=self.cfg,
                                          pool=self.pool)
            self.get = self.allocator.get_available_gpus
            self.resource = self.cfg.gpu_resource_name
        self.node = self.cluster.node_name
        self.kube = self.cluster.kube
        for series in ("WARM_POOL_HITS", "WARM_POOL_MISSES", "WARM_POOL_REFILLS",
                       "WARM_POOL_REFILL_FAILURES"):
            getattr(self.mod, series)._values.clear()

    def count(self, series: str) -> float:
        return getattr(self.mod, series)._values.get((), 0.0)

    def warm(self) -> set[str]:
        return {p["metadata"]["name"]
                for p in self.kube.list_pods(self.cfg.pool_namespace,
                                             label_selector=self.mod.WARM_SELECTOR)}

    def owner(self, name):
        return self.cluster.add_target_pod(name)

    def close(self):
        self.pool.stop()
        self.fp.disarm_all()
        if self.kind == "reference":
            self.cluster.stop()
        else:
            self.cluster.stop()


def _both(tmp_path, size, scenario, **cfg):
    seen = {}
    for kind in ("reference", "port"):
        side = _Side(kind, tmp_path, size, **cfg)
        try:
            seen[kind] = scenario(side)
        finally:
            side.close()
    assert seen["port"] == seen["reference"], seen
    return seen["port"]


def test_adoption_uses_prescheduled_holders(tmp_path):
    def scenario(s):
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        ready = s.pool.ready_count(s.node)
        pooled = s.warm()
        owner = s.owner("trainer")
        devices, slaves = s.get(owner, 2, 1)
        labels = [s.kube.get_pod(s.cfg.pool_namespace, n)["metadata"] for n in slaves]
        owned = all(m["labels"]["tpumounter.io/owner-uid"] == owner.uid
                    and s.mod.WARM_LABEL not in m["labels"]
                    and m["annotations"]["tpumounter.io/owner"] == "trainer" for m in labels)
        listed = {p.name for p in s.allocator.slave_pods_for(owner)} == set(slaves)
        s.pool.refill_once()
        return (ready, len(devices), set(slaves) == pooled, s.count("WARM_POOL_HITS"), owned,
                listed, s.pool.ready_count(s.node))

    assert _both(tmp_path, 2, scenario) == (2, 2, True, 2.0, True, True, 2)


def test_drained_pool_degrades_to_cold_path(tmp_path):
    def scenario(s):
        devices, slaves = s.get(s.owner("trainer"), 2, 1)
        return (len(devices), all(n.startswith("trainer-slave-pod-") for n in slaves),
                s.count("WARM_POOL_MISSES"), s.count("WARM_POOL_HITS"))

    assert _both(tmp_path, 2, scenario) == (2, True, 2.0, 0.0)


def test_no_double_adopt_under_concurrent_mounts(tmp_path):
    def scenario(s):
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        owners = [s.owner(f"tenant-{i}") for i in range(2)]
        results = {}

        def mount(i):
            results[i] = s.get(owners[i], 1, 1)

        threads = [threading.Thread(target=mount, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        slaves = [results[i][1] for i in range(2)]
        uuids = {results[i][0][0].uuid for i in range(2)}
        owned = all({p.name for p in s.allocator.slave_pods_for(o)} == set(sl)
                    for o, sl in zip(owners, slaves))
        return (sorted(len(x) for x in slaves), set(slaves[0]).isdisjoint(slaves[1]),
                len(uuids), owned, s.count("WARM_POOL_HITS"), s.count("WARM_POOL_MISSES"))

    assert _both(tmp_path, 1, scenario) == ([1, 1], True, 2, True, 1.0, 1.0)


def test_refill_failures_leave_no_stranded_holders(tmp_path):
    def scenario(s):
        s.pool.ensure_node(s.node)
        with s.fp.armed({"pool.refill": "error(refill boom)"}):
            s.pool.refill_once()
            during = (s.pool.ready_count(s.node), s.warm(), s.count("WARM_POOL_REFILL_FAILURES"))
            devices, _ = s.get(s.owner("trainer"), 1, 1)
        time.sleep(0.06)
        s.pool.refill_once()
        return during, len(devices), s.pool.ready_count(s.node), s.count("WARM_POOL_REFILLS")

    assert _both(tmp_path, 2, scenario, warm_pool_retry_s=0.05) == ((0, set(), 1.0), 1, 2, 2.0)


def test_unschedulable_refill_deletes_holder_and_backs_off(tmp_path):
    def scenario(s):
        s.get(s.owner("hog"), N, 1)
        creates0 = s.kube.create_calls
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        first = (s.pool.ready_count(s.node), s.warm(), s.kube.create_calls - creates0)
        s.pool.refill_once()
        return first, s.kube.create_calls - creates0, s.count("WARM_POOL_REFILL_FAILURES")

    assert _both(tmp_path, 1, scenario, slave_pod_timeout_s=0.4,
                 warm_pool_retry_s=30.0) == ((0, set(), 1), 1, 1.0)


def test_worker_restart_readopts_running_holders(tmp_path):
    def scenario(s):
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        s.pool.stop()

        def manifest(name, node, n="1"):
            return {"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": name, "namespace": s.cfg.pool_namespace,
                                 "labels": dict(pair.split("=") for pair in
                                                s.mod.WARM_SELECTOR.split(","))},
                    "spec": {"nodeSelector": {"kubernetes.io/hostname": node},
                             "containers": [{"name": "p", "resources": {
                                 "limits": {s.resource: n}, "requests": {s.resource: n}}}]}}

        s.kube.create_pod(s.cfg.pool_namespace, manifest("warm-slave-stray", s.node, "9"))
        s.kube.create_pod(s.cfg.pool_namespace, manifest("warm-slave-foreign", "ghost"))
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            pod = s.kube.get_pod(s.cfg.pool_namespace, "warm-slave-stray")
            if pod["status"].get("phase") == "Pending" and pod["status"].get("conditions"):
                break
            time.sleep(0.01)
        creates0 = s.kube.create_calls
        pool2 = s.mod.WarmPodPool(s.kube, cfg=s.cfg, refill_async=False)
        pool2.ensure_node(s.node)
        names = s.warm()
        return (pool2.ready_count(s.node), s.kube.create_calls - creates0,
                "warm-slave-stray" in names, "warm-slave-foreign" in names, len(names))

    assert _both(tmp_path, 2, scenario) == (2, 0, False, True, 3)


def test_entire_mount_bypasses_pool(tmp_path):
    def scenario(s):
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        devices, slaves = s.get(s.owner("trainer"), 2, 2)
        return (len(devices), len(slaves), slaves[0].startswith("trainer-slave-pod-"),
                s.count("WARM_POOL_HITS"), s.pool.ready_count(s.node))

    assert _both(tmp_path, 2, scenario) == (2, 1, True, 0.0, 2)


def test_set_drained_releases_holders_and_pauses_refill(tmp_path):
    """The health plane's drain toggle: a drained node's holders go and its
    refills pause; undrained, the next pass restocks."""
    def scenario(s):
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        released = s.pool.set_drained(s.node, True)
        drained = (s.pool.drained(s.node), s.pool.ready_count(s.node), s.warm())
        paused = s.pool.refill_once()
        s.pool.set_drained(s.node, False)
        restocked = s.pool.refill_once()
        return (released, drained, paused, restocked, s.pool.ready_count(s.node),
                getattr(s.mod, "WARM_POOL_DRAINED")._values.get((), 0.0) > 0)

    assert _both(tmp_path, 2, scenario) == (2, (True, 0, set()), 0, 2, 2, True)


def test_warm_pool_refill_backs_off_during_outage():
    """ApiHealth not ok: a refill pass creates and deletes nothing; healthy
    again, it creates."""
    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
    from gpumounter_tpu.k8s.health import ApiHealth as RefHealth
    from gpumounter_tpu.k8s.errors import PartitionError as RefPartition
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.k8s.errors import PartitionError
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.k8s.health import ApiHealth

    # no scheduler on the bare fakes: the healthy pass's holders never run,
    # so a short wait keeps the case cheap (the reference waits its 120 s)
    knobs = dict(warm_pool_size=2, api_health_degraded_failures=2,
                 api_health_down_after_s=60.0, api_health_recovery_successes=2,
                 slave_pod_timeout_s=0.3)
    seen = {}
    for kind, mod, fake, health_cls, part, cfg in (
            ("reference", ref_pool_mod, RefFake(), RefHealth, RefPartition,
             RefConfig().replace(**knobs)),
            ("port", pool_mod, FakeKubeClient(), ApiHealth, PartitionError,
             dataclasses.replace(Config(), **knobs))):
        health = health_cls(cfg=cfg)
        pool = mod.WarmPodPool(fake, cfg=cfg, refill_async=False, apihealth=health)
        pool.ensure_node("n1")
        for _ in range(2):
            health.record_failure(part("outage"))
        before = fake.create_calls
        skipped = (pool.refill_once(), fake.create_calls - before, fake.delete_calls)
        health.record_success()
        health.record_success()
        pool_after = pool.refill_once() >= 0
        seen[kind] = (skipped, pool_after, fake.create_calls > before)
    assert seen["port"] == seen["reference"] == ((0, 0, 0), True, True)


def test_a_worker_built_with_a_pool_adopts_and_its_span_says_so(tmp_path):
    """GpuMountService builds the pool from WARM_POOL_SIZE; a single-GPU add
    adopts a warm holder, and the add's ``mount.slave_pod_schedule`` span
    carries pool_hit 1, pool_gap 0, pool_enabled."""
    from gpumounter_tpu_torch.obs import trace
    from gpumounter_tpu_torch.rpc.api import AddGPURequest, AddGPUResult
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "c"), 2)
    cluster.cfg = dataclasses.replace(cluster.cfg, warm_pool_size=1)
    service = cluster.service(str(tmp_path / "dev"))
    try:
        assert service.pool is not None and service.allocator.pool is service.pool
        service.pool.refill_async = False
        service.pool.ensure_node(cluster.node_name)
        service.pool.refill_once()
        cluster.add_target_pod("trainer")
        response = service.add_gpu(AddGPURequest(pod_name="trainer", namespace="default",
                                                 gpu_num=1, is_entire_mount=False))
        assert response.add_gpu_result == AddGPUResult.Success
        spans = [s for s in trace.TRACER.ring.snapshot()
                 if s["name"] == "mount.slave_pod_schedule"]
        assert spans[-1]["attrs"]["pool_hit"] == 1 and spans[-1]["attrs"]["pool_gap"] == 0
        assert spans[-1]["attrs"]["pool_enabled"] is True
    finally:
        service.pool.stop()
        cluster.stop()


def test_an_unschedulable_refill_is_deleted_at_once_where_the_reference_waits(tmp_path):
    """A fault of the reference not carried over: its refill waits for an
    Unschedulable holder until SLAVE_POD_TIMEOUT_S on the refill thread; the
    port's deletes it on the scheduler's verdict and backs the node off. On
    a node whose GPUs are all held, one refill pass, timeout 1 s."""
    def scenario(s):
        s.get(s.owner("hog"), N, 1)
        s.pool.ensure_node(s.node)
        t0 = time.monotonic()
        s.pool.refill_once()
        return time.monotonic() - t0, s.pool.ready_count(s.node), s.warm()

    seen = {}
    for kind in ("reference", "port"):
        side = _Side(kind, tmp_path, 1, slave_pod_timeout_s=1.0, warm_pool_retry_s=30.0)
        try:
            seen[kind] = scenario(side)
        finally:
            side.close()
    assert seen["reference"][0] >= 1.0 and seen["port"][0] < 0.5
    assert seen["reference"][1:] == seen["port"][1:] == (0, set())


class _Clock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


class _SimulatedWaits:
    """A side's API whose pod waits run on `clock`: a wait whose predicate
    an Unschedulable pod does not meet (or any pod within 5 s of real time)
    is taken to have run out its whole timeout, and moves the clock by it."""

    def __init__(self, kube, clock: _Clock):
        self._kube, self._clock = kube, clock

    def __getattr__(self, name):
        return getattr(self._kube, name)

    def wait_for_pod(self, namespace, name, predicate, timeout_s):
        from gpumounter_tpu_torch.k8s.types import Pod
        end = time.monotonic() + 5.0
        while True:
            try:
                pod = self._kube.get_pod(namespace, name)
            except Exception:  # noqa: BLE001 — a pod that is gone is None
                pod = None
            if predicate(pod):
                return pod
            if (pod is not None and Pod(pod).unschedulable_reason() is not None) \
                    or time.monotonic() > end:
                self._clock.now += timeout_s
                return None
            time.sleep(0.01)


def test_a_full_node_sees_the_references_create_rate_once_the_backoff_has_grown(
        tmp_path, monkeypatch):
    """A node whose GPUs are all held, 20 minutes on a simulated clock with
    the defaults (SLAVE_POD_TIMEOUT_S 120, WARM_POOL_RETRY_S 5) and a refill
    pass every second, as the refill thread wakes. The reference creates a
    holder every 125 s (it waits out the timeout, then backs off); the port's
    holder is refused at once, and its backoff doubles from 5 s to 125 s. So
    in the last 10 minutes the port creates as many holders as the
    reference, 5, and in all 20 the 4 of its ramp more (a backoff that stayed
    at 5 s would create one every 5 s)."""
    seen = {}
    for kind in ("reference", "port"):
        side = _Side(kind, tmp_path, 1, slave_pod_timeout_s=120.0, warm_pool_retry_s=5.0)
        clock = _Clock()
        monkeypatch.setattr(side.mod, "time", type("T", (), {
            "monotonic": staticmethod(clock.monotonic), "sleep": staticmethod(time.sleep)}))
        try:
            side.get(side.owner("hog"), N, 1)
            side.pool.kube = _SimulatedWaits(side.kube, clock)
            side.pool.ensure_node(side.node)
            start, stamps = clock.now, []
            while clock.now < start + 1200.0:
                before, at = side.kube.create_calls, clock.now
                side.pool.refill_once()
                if side.kube.create_calls > before:
                    stamps.append(at - start)
                clock.now += 1.0
            seen[kind] = (stamps, side.pool.ready_count(side.node), side.warm())
        finally:
            monkeypatch.undo()
            side.close()
    assert seen["reference"][1:] == seen["port"][1:] == (0, set())
    assert seen["reference"][0] == [125.0 * k for k in range(10)]
    assert seen["port"][0] == [0.0, 5.0, 15.0, 35.0, 75.0, 155.0,
                               *(155.0 + 125.0 * k for k in range(1, 9))]
    late = {kind: sum(1 for t in stamps if t >= 600.0) for kind, (stamps, _, _) in seen.items()}
    assert late == {"reference": 5, "port": 5}


def test_the_workers_own_release_ends_a_full_nodes_backoff_where_the_reference_waits(
        tmp_path):
    """A difference on purpose: the pool's backoff on a full node ends when
    the worker deletes slave pods of that node (``capacity_freed``), since a
    GPU is then free, so the next refill pass refills at once; the
    reference's node stays backed off for WARM_POOL_RETRY_S (30 s here)."""
    def scenario(s):
        _, slaves = s.get(s.owner("hog"), N, 1)
        s.pool.ensure_node(s.node)
        s.pool.refill_once()
        refused = (s.pool.ready_count(s.node), s.count("WARM_POOL_REFILL_FAILURES"))
        s.allocator.delete_slave_pods(slaves)
        return refused, s.pool.refill_once(), s.pool.ready_count(s.node)

    seen = {}
    for kind in ("reference", "port"):
        side = _Side(kind, tmp_path, 1, slave_pod_timeout_s=0.4, warm_pool_retry_s=30.0)
        try:
            seen[kind] = scenario(side)
        finally:
            side.close()
    assert seen["reference"] == ((0, 1.0), 0, 0)
    assert seen["port"] == ((0, 1.0), 1, 1)
