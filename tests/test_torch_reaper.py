"""The slave reaper: the port's ``worker/reaper.py`` against the reference's.

The cases of ``tests/test_reaper.py`` run on both packages' fake clusters
(4 accelerators): an owner deleted, recreated under a new UID or finished
has its slave pods reaped and its GPUs freed; a live owner's are kept, and a
hand-made pod in the pool (``app=gpu-pool`` in the port, ``app=tpu-pool``
in the reference) is left alone. What each pass deleted must be that side's
slave pods, and the free counts equal. Then the grant GC of
``tests/test_ebpf_persistence.py::test_reaper_invokes_grant_gc`` on both
packages' v2 controllers over a stubbed kernel, and the loop's start and
stop.
"""

from __future__ import annotations

import os
import shutil
import threading

import pytest
from torch_durability import short_root

from gpumounter_tpu.allocator.allocator import TpuAllocator
from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.reaper import SlaveReaper as RefReaper
from gpumounter_tpu_torch.allocator.allocator import GpuAllocator
from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.testing.bpf import FakeBpf
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.worker import reaper
from gpumounter_tpu_torch.worker.reaper import SlaveReaper

N = 4


class _RefSide:
    pool_label = "tpu-pool"
    reaper_cls = RefReaper

    def __init__(self):
        self.root = short_root()
        self.cluster = RefCluster(self.root, n_chips=N).start()
        collector = TpuCollector(backend=self.cluster.backend, podresources=PodResourcesClient(
            self.cluster.cfg.kubelet_socket, timeout_s=5.0), cfg=self.cluster.cfg)
        self.allocator = TpuAllocator(self.cluster.kube, collector, cfg=self.cluster.cfg)

    def allocate(self, owner, n):
        return self.allocator.get_available_tpus(owner, n, 1)[1]

    def free(self):
        return self.cluster.free_chip_count()

    def close(self):
        self.cluster.stop()
        shutil.rmtree(self.root, ignore_errors=True)


class _PortSide:
    pool_label = "gpu-pool"
    reaper_cls = SlaveReaper

    def __init__(self, root):
        self.cluster = FakeCluster.with_fake_gpus(root, N)
        collector = GpuCollector(self.cluster.backend, self.cluster.kubelet, cfg=self.cluster.cfg)
        self.allocator = GpuAllocator(self.cluster.kube, collector, cfg=self.cluster.cfg)

    def allocate(self, owner, n):
        return self.allocator.get_available_gpus(owner, n, 1)[1]

    def free(self):
        return self.cluster.free_gpu_count()

    def close(self):
        self.cluster.stop()


@pytest.fixture()
def sides(tmp_path):
    made = {"reference": _RefSide(),
            "port": _PortSide(str(tmp_path / "port"))}
    yield made
    for side in made.values():
        side.close()


def _reaper(side):
    return side.reaper_cls(side.cluster.kube, cfg=side.cluster.cfg)


def orphan_slaves_are_freed(side):
    owner = side.cluster.add_target_pod("trainer")
    slaves = side.allocate(owner, 2)
    reaper_ = _reaper(side)
    alive = (reaper_.reap_once(), side.free())
    side.cluster.kube.delete_pod("default", "trainer")
    return alive, sorted(reaper_.reap_once()) == sorted(slaves), side.free()


def a_recreated_owner_is_detected(side):
    owner = side.cluster.add_target_pod("trainer")
    slaves = side.allocate(owner, 1)
    side.cluster.kube.delete_pod("default", "trainer")
    side.cluster.add_target_pod("trainer")  # the same name, a new UID
    return _reaper(side).reap_once() == slaves, side.free()


def foreign_pods_are_ignored(side):
    pool = side.cluster.cfg.pool_namespace
    side.cluster.kube.create_pod(pool, {
        "metadata": {"name": "someone-elses-pod", "namespace": pool,
                     "labels": {"app": side.pool_label}},
        "spec": {"containers": [{"name": "x"}]}})
    return _reaper(side).reap_once(), len(side.cluster.kube.list_pods(pool))


def a_finished_owner_is_reaped(side):
    owner = side.cluster.add_target_pod("trainer")
    slaves = side.allocate(owner, 1)
    side.cluster.kube.set_pod_status("default", "trainer", phase="Succeeded")
    return _reaper(side).reap_once() == slaves, side.free()


CASES = [orphan_slaves_are_freed, a_recreated_owner_is_detected, foreign_pods_are_ignored,
         a_finished_owner_is_reaped]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_a_reaper_case_ends_as_the_references(sides, case):
    got = {name: case(side) for name, side in sides.items()}
    assert got["port"] == got["reference"]


def test_the_port_selects_its_own_pool_label():
    assert reaper.SLAVE_SELECTOR == "app=gpu-pool"


# --- the grant GC (tests/test_ebpf_persistence.py::test_reaper_invokes_grant_gc) ---

PACKAGES = {
    "reference": (ref_ebpf, RefReaper, RefCluster,
                  lambda: TpuDevice(index=0, device_path="/dev/nvidia0", major=195, minor=0,
                                    uuid="GPU-0")),
    "port": (ebpf, SlaveReaper, None,
             lambda: GpuDevice(index=0, device_path="/dev/nvidia0", major=195, minor=0,
                               uuid="GPU-0")),
}


def test_a_pass_collects_the_grants_of_dead_cgroups(tmp_path):
    """A granted cgroup whose container went: one pass drops the
    controller's state and its journal, in both packages."""
    seen = {}
    for name, (mod, reaper_cls, ref_cluster, device) in PACKAGES.items():
        root = tmp_path / name
        cg = root / "cgroup"
        cg.mkdir(parents=True)
        cg_key = os.path.realpath(str(cg))
        kernel = FakeBpf()
        kernel.preattach(cg_key, 7)
        cluster_root = short_root()
        cluster = (ref_cluster(cluster_root, n_chips=1).start() if ref_cluster
                   else FakeCluster.with_fake_gpus(cluster_root, 1))
        with kernel.installed(mod):
            ctl = mod.V2DeviceController(pin_dir=str(root / "bpffs"),
                                         state_dir=str(root / "state"))
            try:
                ctl.grant(cg_key, device())
                granted = (len(ctl._state), len(os.listdir(root / "state")))
                os.rmdir(cg)
                reaper_cls(cluster.kube, cfg=cluster.cfg, device_controller=ctl).reap_once()
                seen[name] = (granted, ctl._state, os.listdir(root / "state"))
            finally:
                ctl.close()
                cluster.stop()
                shutil.rmtree(cluster_root, ignore_errors=True)
    assert seen["port"] == seen["reference"] == ((1, 1), {}, [])


class _Controller:
    """A controller whose GC is counted, and fails when asked to."""

    def __init__(self, fail=False):
        self.calls = 0
        self.fail = fail

    def gc_dead_cgroups(self):
        self.calls += 1
        if self.fail:
            raise OSError("bpffs gone")
        return []


def test_a_failed_gc_does_not_stop_the_pass(sides):
    """Each package calls the GC once a pass, and reaps all the same when
    it raises."""
    for side in sides.values():
        owner = side.cluster.add_target_pod("trainer")
        slaves = side.allocate(owner, 1)
        side.cluster.kube.delete_pod("default", "trainer")
        ctl = _Controller(fail=True)
        reaper_ = side.reaper_cls(side.cluster.kube, cfg=side.cluster.cfg, device_controller=ctl)
        assert (reaper_.reap_once(), ctl.calls, side.free()) == (slaves, 1, N)


def test_start_runs_the_first_pass_at_once_and_stop_ends_the_loop(sides):
    side = sides["port"]
    ctl = _Controller()
    passed = threading.Event()
    reaper_ = SlaveReaper(side.cluster.kube, cfg=side.cluster.cfg, interval_s=3600,
                          device_controller=ctl)
    once = reaper_.reap_once

    def counted():
        out = once()
        passed.set()
        return out

    reaper_.reap_once = counted
    reaper_.start()
    assert passed.wait(10)
    reaper_.stop()
    assert not reaper_._thread.is_alive() and ctl.calls == 1
