"""Multi-host slices and batch mounts: the master's /addslice, /removeslice
and /batch/addgpu.

The counterpart of ``gpumounter_tpu/master/slice_ops.py``. The original
GPUMounter mounts into one pod on one node per request. A distributed job
spans hosts, and hot-adding GPUs to it means mounting on every host's pod
at once:

  1. ``SliceCoordinator.mount_slice`` checks every pod and the plan first,
     then fans AddGPU out to each pod's node worker on the shared fan-out
     core (``utils/fanout.py``);
  2. if any host fails it rolls back every host that mounted: all or
     nothing, since a job with GPUs on three hosts of four hangs at its
     first collective;
  3. it returns a plan of each worker's environment, which the host's tenant
     exports before it re-forms its process group
     (``torchside.visibility.reinit_distributed``).

``BulkMountCoordinator`` takes many independent mounts in one request (a
mount storm), grouped by node, with a result for each target.

Where the reference hands each worker the TPU runtime's variables
(``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES`` and the ICI bounds), the plan
holds what ``torch.distributed`` and ``torchrun`` read: ``MASTER_ADDR``,
``NNODES``, ``NODE_RANK``, ``NPROC_PER_NODE`` and ``WORLD_SIZE``. A worker's
rank is its pod's place in the request: the caller fixes the order.

Each host's call is a span in the caller's trace (``slice.mount_host``,
``slice.remove_host``, ``bulk.mount_node``), carried into the fan-out's
threads with ``trace.attached``. The failpoint ``master.slice.mount`` fires
before anything is resolved; ``master.slice.rollback.skip`` (a value) skips
the rollback, the leak the chaos harness must detect. Each pod whose mount a
rollback undid gets the Warning Event ``GPUSliceRollback``. With a
``ShardManager`` (``master/shard.py``), every worker call carries the node's
fencing epoch (``epoch_kwargs``), so a worker refuses a stale replica's
writes, and the batch's node groups are budgeted by owner shard on the
fan-out core (one budget pool when the shards are inactive). ``preferIci`` and the
``topology`` hint are TPU torus geometry and stay out: a GPU host's GPUs are
joined by NVSwitch (``topology.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from gpumounter_tpu_torch import topology as topo
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.errors import ApiError, NotFoundError
from gpumounter_tpu_torch.k8s.events import post_pod_event
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.shard import epoch_kwargs
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.rpc.api import AddGPUResult, RemoveGPUResult
from gpumounter_tpu_torch.rpc.resilience import BreakerOpenError
from gpumounter_tpu_torch.utils.fanout import get_core
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("master.slice")


class SliceError(RuntimeError):
    def __init__(self, message: str, status: int = 500, retry_after_s: float | None = None):
        super().__init__(message)
        self.status = status
        #: set when a worker is degraded (its breaker open): the HTTP layer
        #: answers Retry-After
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class SliceTarget:
    namespace: str
    pod: str


def topology_plan(targets: list[SliceTarget], nodes: list[str], pod_ips: list[str],
                  gpus_per_host: int, accel_type: str | None = None) -> dict:
    """Each worker's environment: what the host's tenant exports before it
    re-forms its process group.

    ``MASTER_ADDR`` is the first pod's IP (rank 0's host); ``NODE_RANK`` is
    the pod's index in `targets`; ``NPROC_PER_NODE`` is `gpus_per_host` and
    ``WORLD_SIZE`` is NNODES x NPROC_PER_NODE, so that a process's global
    rank is NODE_RANK x NPROC_PER_NODE + its local rank. The plan names no
    rendezvous port: the tenant picks one.

    With `accel_type` named, ``topology.lookup(accel_type, gpus_per_host x
    hosts)`` must give one host a pod, each of `gpus_per_host` GPUs;
    otherwise SliceError 400, before anything is mounted. ``layout`` is then
    the type, which also goes into the environment as ``ACCELERATOR_TYPE``.
    Unnamed, ``layout`` is "<hosts>x<gpus_per_host>": every GPU of a host is
    joined to every other by NVSwitch and the hosts by the network, so there
    is no geometry to infer or to flag as a guess."""
    hosts = len(targets)
    shared_env = {"MASTER_ADDR": pod_ips[0], "NNODES": str(hosts),
                  "NPROC_PER_NODE": str(gpus_per_host),
                  "WORLD_SIZE": str(hosts * gpus_per_host)}
    if accel_type:
        try:
            layout = topo.lookup(accel_type, gpus_per_host * hosts)
        except topo.TopologyError as exc:
            raise SliceError(str(exc), 400)  # the caller's input, not our fault
        if layout.num_hosts != hosts:
            raise SliceError(f"{layout.accel_type} spans {layout.num_hosts} host(s) but "
                             f"{hosts} pod(s) were given", 400)
        if layout.gpus_per_host != gpus_per_host:
            raise SliceError(f"{layout.accel_type} has {layout.gpus_per_host} GPU(s) per host "
                             f"but gpusPerHost={gpus_per_host} was requested", 400)
        name = layout.accel_type
        shared_env["ACCELERATOR_TYPE"] = name
    else:
        name = f"{hosts}x{gpus_per_host}"
    return {
        "slice": {"num_hosts": hosts, "total_gpus": gpus_per_host * hosts, "layout": name,
                  **shared_env},
        "workers": [
            {"namespace": t.namespace, "pod": t.pod, "node": node, "address": ip,
             "env": {"NODE_RANK": str(i), **shared_env}}
            for i, (t, node, ip) in enumerate(zip(targets, nodes, pod_ips))],
    }


@dataclass(frozen=True)
class BulkTarget:
    """One entry of a POST /batch/addgpu request."""
    namespace: str
    pod: str
    gpus: int = 1
    entire: bool = False


def _api_error(exc: Exception) -> ApiError:
    """An API read's failure as the typed error (the reference's
    ``classify_exception``; its timeout and partition kinds come with 7g's
    ``k8s/health.py``)."""
    return exc if isinstance(exc, ApiError) else ApiError(0, f"{type(exc).__name__}: {exc}")


class BulkMountCoordinator:
    """One request, many pods' mounts (the mount storm).

    Unlike a slice, the targets are independent: a result for each, no
    rollback, no plan. The mounts are grouped by node, so that each node's
    mounts ride one worker client in turn; at most ``bulk_node_fanout``
    node groups mount at once, or ``fanout_shard_budget`` of each owner
    shard when the shards are active, on the shared fan-out core."""

    def __init__(self, kube, registry, client_factory, cfg, shards=None):
        self.kube = kube
        self.registry = registry
        self.client_factory = client_factory
        self.cfg = cfg
        #: an optional ShardManager: its epoch goes on every worker call
        self.shards = shards

    def _epoch(self, node: str) -> dict:
        return epoch_kwargs(self.shards, node)

    def _resolve_bulk(self, targets: list[BulkTarget]
                      ) -> tuple[dict[int, dict], dict[str, list[int]]]:
        """(error entries by index, node -> target indices). A pod that
        cannot be resolved is its own target's result, never the request's:
        one deleted pod must not fail the other mounts."""
        errors: dict[int, dict] = {}
        by_node: dict[str, list[int]] = {}
        for i, t in enumerate(targets):
            try:
                pod = Pod(self.kube.get_pod(t.namespace, t.pod))
            except NotFoundError:
                errors[i] = {"result": "PodNotFound", "error": f"no pod {t.namespace}/{t.pod}"}
                continue
            except Exception as exc:  # noqa: BLE001 — an API blip
                errors[i] = {"result": "Error", "error": str(_api_error(exc))}
                continue
            if not pod.node_name:
                errors[i] = {"result": "NotScheduled",
                             "error": f"pod {t.pod} is not scheduled yet"}
                continue
            by_node.setdefault(pod.node_name, []).append(i)
        return errors, by_node

    def mount_bulk(self, targets: list[BulkTarget],
                   resolution: tuple[dict[int, dict], dict[str, list[int]]] | None = None
                   ) -> list[dict]:
        """A result for each target, in request order: namespace, pod and
        node, with result=Success and the UUIDs mounted, or a result and an
        error (PodNotFound, Error, NotScheduled, NoWorker, Degraded with
        retryAfterS, or the worker's InsufficientGPU / PodNotFound).

        `resolution`: ``_resolve_bulk``'s pair when the caller has resolved
        already (the batch route, to split by owner shard): resolving again
        would read every pod twice and let a pod rescheduled in between
        dodge the routing."""
        results: list[dict | None] = [None] * len(targets)
        errors, by_node = resolution if resolution is not None else self._resolve_bulk(targets)
        for i, err in errors.items():
            results[i] = {"namespace": targets[i].namespace, "pod": targets[i].pod, **err}
        # contextvars stay in their thread: each node group re-attaches this
        trace_ctx = trace.current()

        def _mount_node(node: str, indices: list[int]) -> None:
            def base(i: int) -> dict:
                return {"namespace": targets[i].namespace, "pod": targets[i].pod, "node": node}

            address = self.registry.worker_address(node)
            if address is None:
                for i in indices:
                    results[i] = {**base(i), "result": "NoWorker",
                                  "error": f"no tpumounter worker on node {node}"}
                return
            retry_after = self.registry.breaker.retry_after(address)
            if retry_after is not None:
                for i in indices:
                    results[i] = {**base(i), "result": "Degraded", "retryAfterS": retry_after,
                                  "error": f"worker on {node} degraded (circuit open)"}
                return
            with trace.attached(trace_ctx), \
                    trace.span("bulk.mount_node", node=node, targets=len(indices)), \
                    self.client_factory(address) as client:
                for i in indices:
                    t, entry = targets[i], base(i)
                    try:
                        response = client.add_gpu(t.pod, t.namespace, t.gpus, t.entire,
                                                  **self._epoch(node))
                        entry["result"] = AddGPUResult(response.add_gpu_result).name
                        if response.add_gpu_result == AddGPUResult.Success:
                            entry["uuids"] = list(response.uuids)
                    except Exception as exc:  # noqa: BLE001 — the worker call's boundary
                        entry["result"] = "Error"
                        entry["error"] = str(exc)
                    results[i] = entry

        if by_node:
            # at most fanout_shard_budget node groups in flight of each owner
            # shard (0: no cap), or bulk_node_fanout of all when the shards
            # are inactive (one key); a proxied sub-batch already on the core
            # runs on transient threads
            if self.shards is not None and self.shards.active():
                shard_of = lambda pair: self.shards.owner_shard(pair[0])  # noqa: E731
                budget = int(self.cfg.fanout_shard_budget)
            else:
                shard_of = lambda pair: 0  # noqa: E731 — one budget pool
                budget = max(1, int(self.cfg.bulk_node_fanout))
            get_core(self.cfg).run(list(by_node.items()), lambda pair: _mount_node(*pair),
                                   kind="bulk-mount", shard_of=shard_of, shard_budget=budget)
        return [r if r is not None else
                {"namespace": targets[i].namespace, "pod": targets[i].pod,
                 "result": "Error", "error": "internal: unprocessed"}
                for i, r in enumerate(results)]


class SliceCoordinator:
    def __init__(self, kube, registry, client_factory, cfg, shards=None):
        self.kube = kube
        self.registry = registry
        self.client_factory = client_factory
        self.cfg = cfg
        #: an optional ShardManager: its epoch goes on every worker call
        self.shards = shards

    def _epoch(self, node: str) -> dict:
        return epoch_kwargs(self.shards, node)

    def _resolve(self, targets: list[SliceTarget]) -> list[tuple[SliceTarget, str, str, str]]:
        """[(target, node, worker address, pod IP)], every pod checked
        before any worker is called: 404 no pod, 400 not scheduled, 400 no
        IP, 400 two pods on one node, 500 no worker."""
        out = []
        seen_nodes: dict[str, SliceTarget] = {}
        for t in targets:
            try:
                pod = Pod(self.kube.get_pod(t.namespace, t.pod))
            except NotFoundError:
                raise SliceError(f"No pod: {t.pod} in namespace: {t.namespace}", 404)
            if not pod.node_name:
                raise SliceError(f"Pod {t.pod} is not scheduled yet", 400)
            if not pod.pod_ip:
                raise SliceError(f"Pod {t.pod} has no IP yet", 400)
            if pod.node_name in seen_nodes:
                raise SliceError(f"pods {seen_nodes[pod.node_name].pod} and {t.pod} are on the "
                                 f"same node {pod.node_name}; a slice needs one pod per host",
                                 400)
            seen_nodes[pod.node_name] = t
            address = self.registry.worker_address(pod.node_name)
            if address is None:
                raise SliceError(f"no tpumounter worker on node {pod.node_name}", 500)
            out.append((t, pod.node_name, address, pod.pod_ip))
        return out

    def mount_slice(self, targets: list[SliceTarget], gpus_per_host: int, entire: bool = True,
                    accel_type: str | None = None) -> dict:
        """Mount `gpus_per_host` GPUs into every target's pod, all or none;
        returns ``topology_plan``'s plan. SliceError: 503 when a host
        answered InsufficientGPU or a worker's breaker is open (with
        retry_after_s), 500 for any other failure, after the rollback."""
        if len(targets) < 1:
            raise SliceError("empty slice", 400)
        failpoints.fire("master.slice.mount", pods=[t.pod for t in targets])
        resolved = self._resolve(targets)
        # the plan validates the request: a bad acceleratorType or host count
        # fails here, before any GPU is mounted
        plan = topology_plan(targets, [node for _, node, _, _ in resolved],
                             [ip for _, _, _, ip in resolved], gpus_per_host,
                             accel_type=accel_type)
        # host index -> the AddGPU response, or the exception of the call
        results: dict[int, object] = {}
        # contextvars stay in their thread: each host's call re-attaches this
        trace_ctx = trace.current()

        def _mount(item) -> None:
            i, (t, node, address, _ip) = item
            try:
                with trace.attached(trace_ctx), \
                        trace.span("slice.mount_host", pod=t.pod, gpus=gpus_per_host), \
                        self.client_factory(address) as client:
                    results[i] = client.add_gpu(t.pod, t.namespace, gpus_per_host, entire,
                                                **self._epoch(node))
            except Exception as exc:  # noqa: BLE001 — a host's call; the pass must not raise
                results[i] = exc

        get_core(self.cfg).run(list(enumerate(resolved)), _mount, kind="slice-mount")

        def ok(r) -> bool:
            return not isinstance(r, Exception) and r.add_gpu_result == AddGPUResult.Success

        failures = {i: r for i, r in results.items() if not ok(r)}
        if not failures:
            logger.info("slice mounted: %d host(s) x %d GPU(s)", len(targets), gpus_per_host)
            return plan
        succeeded = [i for i in results if i not in failures]
        logger.error("slice mount failed on %d/%d host(s); rolling back %d", len(failures),
                     len(targets), len(succeeded))
        if failpoints.value("master.slice.rollback.skip", False):
            # the deliberate leak of the chaos harness's control
            logger.error("slice rollback SKIPPED by failpoint; %d host mount(s) leaked",
                         len(succeeded))
            succeeded = []
        for i in succeeded:
            t, node, address, _ip = resolved[i]
            try:
                with self.client_factory(address) as client:
                    # exactly what this request mounted: an empty list would
                    # remove nothing of a single mount and too much of an
                    # entire mount that was there before
                    client.remove_gpu(t.pod, t.namespace, results[i].uuids, force=True,
                                      **self._epoch(node))
            except Exception as exc:  # noqa: BLE001
                logger.error("slice rollback on %s failed: %s", t.pod, exc)
        # A transport failure (a deadline, a dropped connection) may have
        # mounted on the worker after the call died. For an entire mount an
        # empty-UUID remove is exact: it removes all iff the pod ended up
        # entire-mounted (by this request) and is a no-op (GPUNotFound) if
        # the mount never landed. A single mount cannot tell this request's
        # GPUs from earlier ones, so it is left and logged, as in the
        # reference.
        for i, r in failures.items():
            if not isinstance(r, Exception):
                continue  # the worker answered: nothing was mounted
            t, node, address, _ip = resolved[i]
            if not entire:
                logger.error("host %s failed at transport level during a single-mount slice; "
                             "cannot tell the slice's GPUs from earlier ones: a manual remove "
                             "may be needed", t.pod)
                continue
            try:
                with self.client_factory(address) as client:
                    client.remove_gpu(t.pod, t.namespace, [], force=True, **self._epoch(node))
            except Exception as exc:  # noqa: BLE001
                logger.warning("post-timeout rollback probe on %s: %s", t.pod, exc)

        def _fmt(r) -> str:
            return str(r) if isinstance(r, Exception) else AddGPUResult(r.add_gpu_result).name

        detail = "; ".join(f"{resolved[i][0].pod}: {_fmt(r)}" for i, r in failures.items())
        # the rollback where operators look: a Warning Event on each pod
        # whose mount was undone
        for i in succeeded:
            t = resolved[i][0]
            try:
                pod = Pod(self.kube.get_pod(t.namespace, t.pod))
            except Exception as exc:  # noqa: BLE001 — the pod may be gone
                logger.debug("rollback event read of %s/%s failed: %s", t.namespace, t.pod,
                             exc)
                continue
            post_pod_event(self.kube, pod, "GPUSliceRollback",
                           f"slice mount rolled back: {len(failures)}/{len(targets)} host(s) "
                           f"failed ({detail}); removed the {gpus_per_host} GPU(s) mounted "
                           f"here", event_type="Warning", component="tpumounter-master")
        insufficient = any(not isinstance(r, Exception)
                           and r.add_gpu_result == AddGPUResult.InsufficientGPU
                           for r in failures.values())
        # 503: no capacity (retry after a scale-up) and a degraded worker
        # (retry after its cool-down) are both retryable, unlike a fault
        breaker = next((r for r in failures.values() if isinstance(r, BreakerOpenError)), None)
        raise SliceError(f"slice mount failed ({detail})",
                         503 if insufficient or breaker else 500,
                         retry_after_s=breaker.retry_after_s if breaker else None)

    def remove_slice(self, targets: list[SliceTarget], force: bool = False) -> dict:
        """RemoveGPU with remove_all on every host: {"removed": {pod:
        result name or "error: ..."}}. Success and GPUNotFound count as
        done; anything else is SliceError 503 (a breaker open) or 500."""
        resolved = self._resolve(targets)
        results: dict[int, object] = {}
        trace_ctx = trace.current()

        def _remove(item) -> None:
            i, (t, node, address, _ip) = item
            try:
                with trace.attached(trace_ctx), trace.span("slice.remove_host", pod=t.pod), \
                        self.client_factory(address) as client:
                    results[i] = RemoveGPUResult(client.remove_gpu(
                        t.pod, t.namespace, [], force=force, remove_all=True,
                        **self._epoch(node)).remove_gpu_result)
            except Exception as exc:  # noqa: BLE001
                results[i] = exc

        get_core(self.cfg).run(list(enumerate(resolved)), _remove, kind="slice-remove")
        outcome = {resolved[i][0].pod: (r.name if isinstance(r, RemoveGPUResult)
                                        else f"error: {r}")
                   for i, r in results.items()}
        if any(r not in ("Success", "GPUNotFound") for r in outcome.values()):
            breaker = next((r for r in results.values() if isinstance(r, BreakerOpenError)), None)
            raise SliceError(f"slice remove incomplete: {outcome}", 503 if breaker else 500,
                             retry_after_s=breaker.retry_after_s if breaker else None)
        return {"removed": outcome}
