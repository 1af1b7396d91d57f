"""The port's device visibility for CUDA tenants, on the CPU.

The reference counts ``accel*`` nodes and rebuilds the PJRT backend in
place; CUDA enumerates once per process, so the port counts
``nvidia[0-9]+`` nodes, probes CUDA in child processes and hands over to a
new process image. Here the child probe is replaced by a fake, and
``os.execve`` by a recorder: nothing execs inside the test process.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

import pytest
import torch

from gpumounter_tpu.jaxside.visibility import chips_visible_in_dev
from gpumounter_tpu_torch.torchside import visibility
from gpumounter_tpu_torch.torchside.resume import HotResumable
from gpumounter_tpu_torch.torchside.visibility import (
    gpus_visible_in_dev, handoff, refresh_devices, reinit_distributed,
    set_visibility_env, wait_for_gpus)


def _fake_dev(tmp_path):
    """A /dev as a GPU container has it: three GPUs and the nodes and
    directory that are not GPUs."""
    for name in ("nvidia0", "nvidia1", "nvidia7", "nvidiactl", "nvidia-uvm",
                 "nvidia-uvm-tools", "nvidia-modeset", "nvidiaX", "accel0"):
        (tmp_path / name).write_text("")
    (tmp_path / "nvidia-caps").mkdir()
    (tmp_path / "nvidia-caps" / "nvidia-cap1").write_text("")
    return tmp_path


def test_gpus_visible_in_dev_counts_gpu_nodes_only(tmp_path):
    assert gpus_visible_in_dev(str(tmp_path)) == 0
    dev = _fake_dev(tmp_path)
    assert gpus_visible_in_dev(str(dev)) == 3
    # the reference counts the TPU's nodes in the same tree
    assert chips_visible_in_dev(str(dev)) == 1
    assert gpus_visible_in_dev(str(tmp_path / "missing")) == 0


def test_set_visibility_env(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("CUDA_DEVICE_ORDER", "FASTEST_FIRST")
    set_visibility_env(visible_devices="0,1")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert os.environ["CUDA_DEVICE_ORDER"] == "FASTEST_FIRST"  # None: untouched
    set_visibility_env(visible_devices="", device_order="PCI_BUS_ID")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""  # "" hides every device
    assert os.environ["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"


class FakeProbe:
    """Stands in for the child-process CUDA probe: returns `counts` in turn
    (the last one from then on) and records when it was called."""

    def __init__(self, *counts):
        self.counts = list(counts)
        self.calls: list[float] = []

    def __call__(self):
        self.calls.append(time.monotonic())
        return self.counts.pop(0) if len(self.counts) > 1 else self.counts[0]


def test_wait_for_gpus_probes_once_when_the_devices_are_there(tmp_path, monkeypatch):
    probe = FakeProbe(3)
    monkeypatch.setattr(visibility, "_probe_device_count", probe)
    timings = wait_for_gpus(3, timeout_s=5.0, dev_dir=str(_fake_dev(tmp_path)))
    assert set(timings) == {"nodes_visible_ms", "backend_rebuild_ms", "total_ms",
                            "device_count"}
    assert timings["device_count"] == 3 and len(probe.calls) == 1
    assert timings["total_ms"] >= timings["nodes_visible_ms"] >= 0


def test_wait_for_gpus_waits_for_the_nodes(tmp_path, monkeypatch):
    probe = FakeProbe(1)
    monkeypatch.setattr(visibility, "_probe_device_count", probe)
    timer = threading.Timer(0.3, lambda: (tmp_path / "nvidia0").write_text(""))
    timer.start()
    try:
        timings = wait_for_gpus(1, timeout_s=5.0, dev_dir=str(tmp_path),
                                poll_interval_s=0.01)
    finally:
        timer.join()
    assert timings["nodes_visible_ms"] >= 250 and timings["device_count"] == 1
    assert len(probe.calls) == 1  # no probe before the node existed


def test_wait_for_gpus_backs_off_while_nothing_changes(tmp_path, monkeypatch):
    """The node is there but CUDA does not see it yet: the probes come at
    doubling intervals (0.1, 0.2, 0.4 s), not every poll."""
    (tmp_path / "nvidia0").write_text("")
    probe = FakeProbe(0, 0, 0, 0, 1)
    monkeypatch.setattr(visibility, "_probe_device_count", probe)
    timings = wait_for_gpus(1, timeout_s=5.0, dev_dir=str(tmp_path),
                            poll_interval_s=0.01)
    gaps = [b - a for a, b in zip(probe.calls, probe.calls[1:])]
    assert len(probe.calls) == 5 and timings["device_count"] == 1
    for gap, want in zip(gaps, (0.1, 0.2, 0.4, 0.8), strict=True):
        assert gap >= want, gaps


def test_wait_for_gpus_probes_again_when_a_node_appears(tmp_path, monkeypatch):
    """A change in the node count probes at once and restarts the
    backoff."""
    (tmp_path / "nvidia0").write_text("")
    probe = FakeProbe(0, 0, 0, 0, 0, 1)
    monkeypatch.setattr(visibility, "_probe_device_count", probe)
    arrived = []

    def arrive():
        arrived.append(time.monotonic())
        (tmp_path / "nvidia1").write_text("")

    timer = threading.Timer(0.85, arrive)
    timer.start()
    try:
        timings = wait_for_gpus(1, timeout_s=10.0, dev_dir=str(tmp_path),
                                poll_interval_s=0.01)
    finally:
        timer.join()
    # Probes at 0, 0.1, 0.3 and 0.7 s (backing off; the next retry would
    # be at 1.5), at the node's arrival (0.85 s after the timer started,
    # which is a little before the first probe), and 0.1 s after it (the
    # backoff restarted; doubled it would be 1.6 s). The arrival's probe is
    # timed from the arrival itself.
    calls = [t - probe.calls[0] for t in probe.calls]
    assert timings["device_count"] == 1 and len(calls) == 6
    assert 0 <= probe.calls[4] - arrived[0] < 0.55, (calls, arrived[0] - probe.calls[0])
    assert calls[5] - calls[4] < 0.8, calls


@pytest.mark.parametrize("nodes", [0, 1])
def test_wait_for_gpus_times_out(tmp_path, monkeypatch, nodes):
    if nodes:
        (tmp_path / "nvidia0").write_text("")
    monkeypatch.setattr(visibility, "_probe_device_count", FakeProbe(0))
    what = "CUDA sees 0 < 1" if nodes else "0/1 GPU device node"
    with pytest.raises(TimeoutError, match=what):
        wait_for_gpus(1, timeout_s=0.3, dev_dir=str(tmp_path), poll_interval_s=0.01)


def test_refresh_devices_raises_after_cuda_init(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(visibility, "_probe_device_count",
                        lambda: pytest.fail("no probe after init"))
    with pytest.raises(RuntimeError, match="handoff"):
        refresh_devices()


def test_refresh_devices_never_returns_a_stale_count(monkeypatch):
    """Before torch initialises CUDA: the count this process's CUDA holds
    if a fresh process sees the same, else a RuntimeError naming handoff
    (CUDA enumerated earlier, against another device set)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(visibility, "_count_in_this_process", lambda: 2)
    monkeypatch.setattr(visibility, "_probe_device_count", lambda: 2)
    assert refresh_devices() == 2
    monkeypatch.setattr(visibility, "_count_in_this_process", lambda: 0)
    monkeypatch.setattr(visibility, "_probe_device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="holds 0 device.*would see 1.*handoff"):
        refresh_devices()


def test_probe_failure_raises(monkeypatch):
    """The real probe, on a host without the CUDA driver: an error, never
    a count of 0."""
    if os.path.exists("/dev/nvidiactl"):
        pytest.skip("this host has the CUDA driver")
    with pytest.raises(RuntimeError, match="CUDA device probe failed"):
        visibility._probe_device_count()


class _Exec(Exception):
    """Raised by the recording execve in place of replacing the process."""


def test_handoff_saves_flushes_and_execs_the_same_program(tmp_path, monkeypatch):
    calls = []

    def fake_execve(path, args, env):
        calls.append((path, args, env))
        raise _Exec

    monkeypatch.setattr(visibility.os, "execve", fake_execve)
    state = HotResumable.pack({"w": torch.arange(3.0)})
    env = {"CUDA_VISIBLE_DEVICES": "0"}
    before = time.time()
    with pytest.raises(_Exec):
        handoff(state, str(tmp_path / "ckpt"), argv=["train.py", "--resume"], env=env)
    ((path, args, new_env),) = calls
    assert path == sys.executable
    assert args == [sys.executable, "train.py", "--resume"]
    assert new_env["CUDA_VISIBLE_DEVICES"] == "0" and "CUDA_VISIBLE_DEVICES" in env
    assert before <= float(new_env[visibility.HANDOFF_AT_ENV]) <= time.time()
    assert visibility.HANDOFF_AT_ENV not in env  # the caller's dict is not changed
    (loaded,) = HotResumable.load(str(tmp_path / "ckpt")).host_state
    assert torch.equal(loaded["w"], torch.arange(3.0))

    # Defaults: this interpreter's own arguments and environment.
    calls.clear()
    with pytest.raises(_Exec):
        handoff(state, str(tmp_path / "ckpt"))
    ((_, args, new_env),) = calls
    assert args == [sys.executable, *sys.orig_argv[1:]]
    assert {k: v for k, v in new_env.items() if k != visibility.HANDOFF_AT_ENV} \
        == dict(os.environ)


def test_handoff_does_not_exec_when_the_save_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(visibility.os, "execve",
                        lambda *a: pytest.fail("exec after a failed save"))
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        handoff(HotResumable.pack({"w": torch.ones(1)}), str(tmp_path / "file"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_reinit_distributed_with_gloo():
    import torch.distributed as dist
    try:
        reinit_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        # again: the first group is destroyed, a new one formed
        reinit_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
        t = torch.arange(4.0)
        dist.all_reduce(t)
        assert torch.equal(t, torch.arange(4.0))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

