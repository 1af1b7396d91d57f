"""Let a PyTorch tenant take a GPU that was mounted into its running
container.

CUDA enumerates its devices once per process, when the driver is first
initialised (``cuInit``; in PyTorch the first ``torch.cuda.is_available()``
or anything that touches a device), and reads ``CUDA_VISIBLE_DEVICES`` at
that moment only; PyTorch also caches its count from then on. So a process
that has touched CUDA never sees a GPU mounted after that point, and no
in-process rebuild exists, as it does for the TPU's PJRT client. The
hot-add is a new process image instead:

  1. the worker injects ``/dev/nvidiaN`` and the cgroup grant (control
     plane);
  2. the tenant packs its state to the host (``resume.HotResumable.pack``)
     and calls ``handoff``: save, then ``execve`` of the same program with
     the new ``CUDA_VISIBLE_DEVICES`` (same PID, same container);
  3. the new image calls ``wait_for_gpus`` (device nodes, then a CUDA
     probe in a child process), then ``HotResumable.load(path).restore``.

Across hosts, ``reinit_distributed`` re-forms the process group after the
new images start.
"""

from __future__ import annotations

import logging
import os
import re
import subprocess
import sys
import time

import torch

logger = logging.getLogger(__name__)

_GPU_NODE = re.compile(r"nvidia[0-9]+")

#: set by ``handoff`` in the new image's environment: the wall-clock time
#: (``time.time()``) just before the old image's exec, so that the new one
#: can time its own start.
HANDOFF_AT_ENV = "TPUMOUNTER_HANDOFF_AT"

# A fresh CUDA driver initialisation in a child process: the count of
# devices that a process started now would see. It imports nothing but
# ctypes, and prints the count or exits non-zero naming the error.
_PROBE = """
import ctypes, sys
try:
    cuda = ctypes.CDLL("libcuda.so.1")
except OSError as err:
    sys.exit(f"no CUDA driver: {err}")
err = cuda.cuInit(0)
if err == 100:  # CUDA_ERROR_NO_DEVICE
    print(0)
    sys.exit(0)
count = ctypes.c_int(0)
if err == 0:
    err = cuda.cuDeviceGetCount(ctypes.byref(count))
if err != 0:
    sys.exit(f"CUDA driver error {err}")
print(count.value)
"""


def gpus_visible_in_dev(dev_dir: str = "/dev") -> int:
    """Count the GPU device nodes (``nvidia0``, ``nvidia1``, ...) in the
    container; the control nodes (``nvidiactl``, ``nvidia-uvm``,
    ``nvidia-modeset``, ``nvidia-caps/``) are not GPUs."""
    try:
        return sum(1 for n in os.listdir(dev_dir) if _GPU_NODE.fullmatch(n))
    except FileNotFoundError:
        return 0


def set_visibility_env(*, visible_devices: str | None = None,
                       device_order: str | None = None) -> None:
    """Set ``CUDA_VISIBLE_DEVICES`` and ``CUDA_DEVICE_ORDER`` for the next
    CUDA initialisation: a new process image (``handoff``) or a process
    that has not touched CUDA yet. None leaves a variable as it is; ""
    hides every device.

    E.g. a tenant going from GPU 0 to GPUs 0 and 1:
        set_visibility_env(visible_devices="0,1", device_order="PCI_BUS_ID")
    """
    for key, val in (("CUDA_VISIBLE_DEVICES", visible_devices),
                     ("CUDA_DEVICE_ORDER", device_order)):
        if val is not None:
            os.environ[key] = val
            logger.debug("visibility env %s=%s", key, val)


def _probe_device_count(timeout_s: float = 60.0) -> int:
    """The devices a CUDA initialisation sees now, with this process's
    environment, probed in a child process so that this process's own
    CUDA state is never initialised against the old device set."""
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=timeout_s, env=os.environ.copy())
    if out.returncode != 0:
        raise RuntimeError(f"CUDA device probe failed: {out.stderr.strip()}")
    return int(out.stdout)


def _count_in_this_process() -> int:
    """The device count this process's CUDA runtime holds, initialising it
    now if nothing has (PyTorch keeps the first count it reads)."""
    return torch._C._cuda_getDeviceCount()


def refresh_devices() -> int:
    """The number of CUDA devices this process can use, read now.

    Raises RuntimeError when that is not the number a process started now
    would see: this process initialised CUDA (PyTorch, or a first
    ``torch.cuda.is_available()``) against another device set, and CUDA
    cannot enumerate again. Such a process takes a new device through
    ``handoff``. A count is never returned stale.
    """
    why = ("CUDA enumerates devices once per process, at its first "
           "initialisation; a GPU mounted since is invisible here. Save "
           "the state and start a new process image with "
           "torchside.visibility.handoff")
    if torch.cuda.is_initialized():
        raise RuntimeError(f"this process has initialised CUDA. {why}")
    here, fresh = _count_in_this_process(), _probe_device_count()
    if here != fresh:
        raise RuntimeError(f"this process's CUDA holds {here} device(s), a new "
                           f"process would see {fresh}. {why}")
    logger.info("CUDA devices: %d", here)
    return here


def wait_for_gpus(expected: int, timeout_s: float = 30.0,
                  dev_dir: str = "/dev",
                  poll_interval_s: float = 0.05) -> dict:
    """Block until `expected` GPUs are mounted and a CUDA initialisation
    sees them.

    Call it before this process touches CUDA (a new image after
    ``handoff``): the probes run in child processes, so this process then
    initialises CUDA against the device set they saw. Returns phase timings
    (ms): nodes_visible (device nodes present), backend_rebuild (the child
    probes), total; and device_count. Raises TimeoutError.
    """
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    while gpus_visible_in_dev(dev_dir) < expected:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"only {gpus_visible_in_dev(dev_dir)}/{expected} GPU device "
                f"node(s) in {dev_dir} after {timeout_s}s")
        time.sleep(poll_interval_s)
    t_nodes = time.monotonic()

    # A probe starts a process and initialises the CUDA driver, so probe
    # once now that the nodes exist, then again only when the node count
    # changes or on an exponentially backed-off retry (a probe can race the
    # driver's readiness: node present, device not yet enumerable). A slow
    # attach costs O(changes + log(timeout)) probes.
    count = _probe_device_count()
    nodes_at_probe = gpus_visible_in_dev(dev_dir)
    retry_wait = max(poll_interval_s, 0.1)
    next_retry = time.monotonic() + retry_wait
    while count < expected:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"CUDA sees {count} < {expected} device(s) after {timeout_s}s")
        time.sleep(poll_interval_s)
        nodes_now = gpus_visible_in_dev(dev_dir)
        now = time.monotonic()
        changed = nodes_now != nodes_at_probe
        if changed or now >= next_retry:
            count = _probe_device_count()
            nodes_at_probe = nodes_now
            # A new node restarts the backoff; an unchanged set doubles it.
            retry_wait = (max(poll_interval_s, 0.1) if changed
                          else min(retry_wait * 2, 5.0))
            next_retry = time.monotonic() + retry_wait
    t_done = time.monotonic()
    timings = {
        "nodes_visible_ms": round((t_nodes - t0) * 1000.0, 3),
        "backend_rebuild_ms": round((t_done - t_nodes) * 1000.0, 3),
        "total_ms": round((t_done - t0) * 1000.0, 3),
        "device_count": count,
    }
    logger.info("GPUs visible: %s", timings)
    return timings


def handoff(state, path: str, argv: list[str] | None = None,
            env: dict[str, str] | None = None):
    """Hand the tenant over to a new process image that sees the new
    device set: wait for the device's work, ``state.save(path)``, flush
    stdout and stderr, and ``os.execve`` the same interpreter. The PID and
    the container stay; the process image, and so CUDA's enumeration,
    are new. The new image calls ``HotResumable.load(path).restore()``.
    Descriptors opened close-on-exec do not reach it: Python's own (PEP
    446), the checkpoint's ``.lock``, and the CUDA driver's device files,
    so the old image's device memory is released at the exec.

    argv: the new image's arguments after the interpreter (default this
    process's own, ``sys.orig_argv[1:]``, which a program started with
    ``-c`` keeps too). env: its environment (default ``os.environ``, e.g.
    after ``set_visibility_env``); ``TPUMOUNTER_HANDOFF_AT`` is added.
    Never returns: a failed save or exec raises.
    """
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    state.save(path)
    args = list(sys.orig_argv[1:] if argv is None else argv)
    new_env = dict(os.environ if env is None else env)
    logger.info("handing off to a new image: %s %s", sys.executable,
                " ".join(args))
    sys.stdout.flush()
    sys.stderr.flush()
    new_env[HANDOFF_AT_ENV] = repr(time.time())
    os.execve(sys.executable, [sys.executable, *args], new_env)


def reinit_distributed(coordinator_address: str, num_processes: int,
                       process_id: int) -> None:
    """Re-form the process group after a device-set change, on every
    process: destroy the current group if there is one, then
    ``init_process_group`` over ``tcp://coordinator_address`` (host:port),
    with torch.distributed's default backends (gloo for CPU tensors, nccl
    for CUDA ones)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info("torch.distributed re-initialised: %d process(es), rank %d",
                num_processes, process_id)
