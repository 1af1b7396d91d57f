"""gpumounter CLI: local single-node mode + master client.

The counterpart of ``gpumounter_tpu/cli.py``: the same verbs, exit codes and
output, against the port's master and on the host's NVIDIA GPUs. What
differs on purpose (ROADMAP §3 "The CLI in its NVIDIA form"): the routes are
the port's (``/addgpu``, ``/removegpu``, ``/batch/addgpu``, whose targets
count ``gpus``); the flags that count or name devices say GPU (``mount
--gpus``, ``intent set --gpus/--min-gpus``, ``shares --gpus/--gpu``,
``bulk-add --target [NS/]POD[:GPUS]``), while the request bodies keep the
reference's JSON keys (``desiredChips``, ``minChips``, the shares body's
``chips`` and ``inventory``); ``probe`` reports the identity source, NVML,
the cgroup and the namespace helper in place of libtpu and the native
library; and the text the CLI writes itself says "GPU(s)" where the
reference's says "chip(s)". A master's body is printed as it is.

Two families of verbs:

  Local (no Kubernetes anywhere):
    devices                          GPU inventory + busy holders
    probe                            identity source, NVML, cgroup, helper
    mount   --target-dev DIR [--pid N] [--cgroup DIR] --gpus N | --uuid U..
    unmount --target-dev DIR [--pid N] [--cgroup DIR] --uuid U.. [--force]

  Remote (against a running master, the HTTP API of the original's
  QuickStart curl examples). `--master` accepts a single URL or a
  comma-separated replica list: endpoints fail over on connection errors
  and shard 307 redirects are followed (rpc/http_failover.py +
  master/shard.py):
    add     --master URL[,URL...] --namespace NS --pod POD --num N
    bulk-add --master URL --target [NS/]POD[:GPUS] ...   one request,
                                   many mounts (POST /batch/addgpu)
    remove  --master URL --namespace NS --pod POD --uuids U,U [--force]
    intent set|get|delete|list     declarative GPU-count intents
    migrate start|status|abort     live GPU migration between pods
    audit   [--pod POD] [--trace ID] [--op PREFIX]   the audit trail
    trace ID                       assembled waterfall for one trace
    why ID                         the dominant critical-path phase of
                                   one trace and its share of wall time
                                   (exit 3 on incomplete assembly)
    timeline [--node N] [--trace ID] [--kind K] [--since F] [--until T]
                                   incident flight recorder
    fleet                          federated per-node fleet rollup
                                   (stale nodes flagged on stderr)
    slo                            SLO burn-rate evaluation
    tenants [--tenant T]           per-tenant disruption ledger
    capacity [--accel-type T]      capacity pane: GPU inventory, the
                                   NVSwitch fragmentation index, the
                                   per-shape feasibility table, headroom
                                   (exit 3 when a shape is infeasible)
    shards                         shard -> owner replica table
    recovery [--evacuate NODE]     node-failure recovery plane
    health [--quarantine|--release NODE]   gray-failure health plane
    defrag [--plan|--run|--pause]  the defragmenter (exit 3 when gated)
    autoscale [--pause|--resume|--evaluate]   the autoscaler
    shares [--admit|--release]     fractional GPU shares
    apihealth                      API-outage degraded mode (exit 3 when
                                   not healthy)
                                   (the observability verbs accept
                                   --read-token: the read-only scope)

    python -m gpumounter_tpu_torch.cli <verb> ...

Exit codes (scriptable — a bad request is not a rollback):
    0  success
    1  generic error (transport failure, unexpected status)
    2  request rejected before anything moved (source == destination,
       unknown pod, already-migrating: any HTTP 4xx; a busy GPU)
    3  migration failed mid-flight (rolled back / failed / aborted), or a
       pane's verdict (capacity, slo, tenants, apihealth, ...) is unhealthy

Importing this module loads the config, the device backend and the logger
only: no torch, numpy or grpc. Each verb imports what it runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import backend_from_config
from gpumounter_tpu_torch.utils.log import init_logger


def _backend():
    return backend_from_config(Config())


def cmd_devices(args) -> int:
    backend = _backend()
    devices = backend.list_devices()
    out = []
    for dev in devices:
        entry = {
            "index": dev.index, "uuid": dev.uuid, "path": dev.device_path,
            "major": dev.major, "minor": dev.minor,
        }
        if args.busy:
            entry["holder_pids"] = backend.running_pids(dev)
        out.append(entry)
    print(json.dumps(out, indent=2))
    return 0


def _nvml_loads(library: str) -> str:
    import ctypes

    try:
        ctypes.CDLL(library)
    except OSError:
        return "unavailable"
    return "loaded"


def cmd_probe(args) -> int:
    """What the host offers the worker, in place of the reference's
    native_lib and libtpu: `identity_source` ("nvml" or "procfs", the
    source that ties a node to a GPU, as identity_from_config picks it from
    GPU_IDENTITY_SOURCE), `nvml` ("loaded" when NVML_LIBRARY, by default
    libnvidia-ml.so.1, loads, else "unavailable"), `gpus` (the backend's
    count), `cgroup_version` and `cgroup_driver` (as the worker detects
    them under CGROUP_ROOT), and the native layer as the reference reports
    its `native_lib`: `nsexec` and `native_lib` (the namespace helper's and
    the /proc scan library's paths, the configured ones or where the build
    puts them) with `nsexec_built` and `native_lib_built` (whether each is
    there; probe builds nothing). Where the identity source cannot list the
    GPUs (no driver, no NVML), `gpus` is 0 and `identity_error` says why."""
    from gpumounter_tpu_torch.cgroup.naming import (
        detect_cgroup_driver,
        detect_cgroup_version,
    )
    from gpumounter_tpu_torch.device.backend import (
        IdentityError,
        NvmlIdentity,
        identity_from_config,
    )
    from gpumounter_tpu_torch import native

    cfg = Config()
    identity = identity_from_config(cfg)
    report = {
        "identity_source": "nvml" if isinstance(identity, NvmlIdentity) else "procfs",
        "nvml": _nvml_loads(cfg.nvml_library),
        "cgroup_version": detect_cgroup_version(cfg.cgroup_root),
        "cgroup_driver": detect_cgroup_driver(cfg.cgroup_root),
        **native.status(),
    }
    try:
        report["gpus"] = len(_backend().list_devices())
    except IdentityError as exc:
        report["gpus"] = 0
        report["identity_error"] = str(exc)
    print(json.dumps(report, indent=2))
    return 0


def _local_mounter_and_target(args):
    from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget

    backend = _backend()
    mounter = GpuMounter(backend)
    target = MountTarget(
        dev_dir=args.target_dev,
        cgroup_dirs=[args.cgroup] if args.cgroup else [],
        ns_pid=args.pid,
        description=f"local:{args.target_dev}")
    return backend, mounter, target


def cmd_mount(args) -> int:
    backend, mounter, target = _local_mounter_and_target(args)
    devices = backend.list_devices()
    chosen = []
    if args.uuid:
        by_uuid = {d.uuid: d for d in devices}
        for u in args.uuid:
            if u not in by_uuid:
                print(f"error: no device with uuid {u}", file=sys.stderr)
                return 1
            chosen.append(by_uuid[u])
    else:
        chosen = devices[:args.gpus]
        if len(chosen) < args.gpus:
            print(f"error: only {len(chosen)} GPU(s) available",
                  file=sys.stderr)
            return 1
    for dev in chosen:
        timings = mounter.mount_many(target, [dev])
        print(json.dumps({"mounted": dev.uuid, "timings_ms": timings}))
    return 0


def cmd_unmount(args) -> int:
    from gpumounter_tpu_torch.worker.mounter import GpuBusyError

    backend, mounter, target = _local_mounter_and_target(args)
    rc = 0
    for u in args.uuid:
        dev = backend.device_by_uuid(u)
        if dev is None:
            print(f"error: no device with uuid {u}", file=sys.stderr)
            rc = 1
            continue
        try:
            timings = mounter.unmount_many(target, [dev], force=args.force)
            print(json.dumps({"unmounted": dev.uuid, "timings_ms": timings}))
        except GpuBusyError as exc:
            print(f"busy: {exc}", file=sys.stderr)
            rc = 2
    return rc


def _endpoints(args, token: str | None):
    """The failover client over `--master` (a URL or a comma-separated
    replica list): tries replicas in order, follows shard redirects
    re-sending the body, and fails over on connection errors/503s
    (rpc/http_failover.py)."""
    from gpumounter_tpu_torch.rpc.http_failover import MasterEndpoints
    return MasterEndpoints(args.master, token=token)


def _http(args, method: str, path: str, form: dict | None = None,
          token: str | None = None,
          json_body: dict | None = None) -> tuple[int, str]:
    """One master request; exits 1 with a one-line error when every
    replica is unreachable (a traceback is not a CLI answer)."""
    from gpumounter_tpu_torch.rpc.http_failover import EndpointError
    try:
        return _endpoints(args, token).request(
            method, path, form=form, json_body=json_body)
    except EndpointError as exc:
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(1)


def _remote_token(args) -> str | None:
    """--token wins (--token '' forces no credentials); else
    TPUMOUNTER_AUTH_TOKEN[_FILE] through the config. A broken token file
    is a one-line error, not a traceback."""
    explicit = getattr(args, "token", None)
    if explicit is not None:
        return explicit or None
    from gpumounter_tpu_torch.utils.auth import AuthConfigError, resolve_token
    try:
        return resolve_token(Config())
    except AuthConfigError as exc:
        print(f"auth: {exc} (pass --token, or --token '' to send none)",
              file=sys.stderr)
        raise SystemExit(2)


def cmd_add(args) -> int:
    path = (f"/addgpu/namespace/{args.namespace}"
            f"/pod/{args.pod}/gpu/{args.num}"
            f"/isEntireMount/{str(args.entire).lower()}")
    status, body = _http(args, "GET", path, token=_remote_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def cmd_remove(args) -> int:
    path = (f"/removegpu/namespace/{args.namespace}"
            f"/pod/{args.pod}/force/{str(args.force).lower()}")
    status, body = _http(args, "POST", path, form={"uuids": args.uuids},
                         token=_remote_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def _intent_path(args, with_pod: bool = True) -> str:
    if with_pod:
        return f"/intents/{args.namespace}/{args.pod}"
    return "/intents"


def cmd_intent_set(args) -> int:
    # the persisted intent keeps the reference's keys (elastic/intents.py)
    payload = {"desiredChips": args.gpus, "minChips": args.min_gpus,
               "priority": args.priority}
    status, body = _http(args, "PUT", _intent_path(args),
                         json_body=payload, token=_remote_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def cmd_intent_get(args) -> int:
    status, body = _http(args, "GET", _intent_path(args),
                         token=_remote_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def cmd_intent_delete(args) -> int:
    status, body = _http(args, "DELETE", _intent_path(args),
                         token=_remote_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def cmd_intent_list(args) -> int:
    status, body = _http(args, "GET", _intent_path(args, with_pod=False),
                         token=_remote_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def _obs_token(args) -> str | None:
    """--read-token (the read-only observability scope) wins over the
    mutate token resolution — scrape/debug boxes usually hold only it."""
    read = getattr(args, "read_token", None)
    if read:
        return read
    return _remote_token(args)


def cmd_audit(args) -> int:
    params = {k: v for k, v in (
        ("namespace", args.namespace), ("pod", args.pod), ("op", args.op),
        ("trace", args.trace), ("outcome", args.outcome),
        ("limit", str(args.limit))) if v}
    path = f"/audit?{urllib.parse.urlencode(params)}"
    status, body = _http(args, "GET", path, token=_obs_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def cmd_trace(args) -> int:
    status, body = _http(args, "GET", f"/trace/{args.id}",
                         token=_obs_token(args))
    print(body.rstrip())
    if status == 404:
        return 2  # unknown/expired trace id: rejected, not a failure
    return 0 if status == 200 else 1


def cmd_why(args) -> int:
    """Answer "why was this operation slow" for one trace id: fetch the
    assembled waterfall (GET /trace/<id>: master + federated worker spans
    joined by obs/assembly.py) and name the dominant critical-path phase
    and its share of wall time. Exit 2 when the trace is unknown/expired,
    3 when the assembly is incomplete (orphan spans, a missing worker half:
    the verdict would lie)."""
    status, body = _http(args, "GET", f"/trace/{args.id}",
                         token=_obs_token(args))
    if status == 404:
        print(body.rstrip(), file=sys.stderr)
        return 2
    if status != 200:
        print(body.rstrip(), file=sys.stderr)
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        print("error: unparseable /trace payload", file=sys.stderr)
        return 1
    nodes = payload.get("nodes") or []
    print(f"trace {args.id}: {payload.get('op') or '?'} took "
          f"{payload.get('wall_ms', 0)}ms across "
          f"{len(payload.get('spans', []))} span(s)"
          + (f" on {', '.join(nodes)}" if nodes else ""))
    for entry in payload.get("critical_path", []):
        print(f"  {entry.get('phase', '?'):<20} "
              f"{entry.get('ms', 0.0):>10.3f} ms  "
              f"{entry.get('share', 0.0) * 100:5.1f}%")
    dominant = payload.get("dominant") or {}
    if dominant:
        print(f"dominant phase: {dominant.get('phase')} "
              f"({dominant.get('share', 0.0):.0%} of wall time)")
    if dominant and nodes:
        # Gray-failure verdict: if a node this trace touched is
        # quarantined, the slow phase is the limping node, not the control
        # plane. Best-effort: a master without the health plane (or an
        # auth scope without it) just skips this.
        try:
            h_status, h_body = _http(args, "GET", "/health/nodes",
                                     token=_obs_token(args))
            health_nodes = (json.loads(h_body).get("nodes") or {}
                            if h_status == 200 else {})
        except (SystemExit, ValueError):
            health_nodes = {}
        if not isinstance(health_nodes, dict):
            health_nodes = {}  # not a health payload: skip the verdict
        for node in nodes:
            pane = health_nodes.get(node) or {}
            if pane.get("state") == "quarantined":
                print(f"verdict: quarantine — node {node} is quarantined "
                      f"({pane.get('reason') or 'no reason recorded'}); "
                      f"this operation ran through a limping node")
                break
    if dominant.get("phase") == "slave_pod_schedule":
        # The cold-mount cause: the slave_pod_schedule spans carry the
        # allocator's warm-pool outcome (pool_hit/pool_gap), so a dominant
        # scheduling phase is told apart as warm-pool starvation or plain
        # scheduler wait.
        hits = gap = 0
        enabled = False
        seen = False
        for entry in payload.get("spans", []):
            if entry.get("name") != "mount.slave_pod_schedule":
                continue
            attrs = entry.get("attrs") or {}
            if "pool_gap" not in attrs and "pool_hit" not in attrs:
                continue
            seen = True
            hits += int(attrs.get("pool_hit", 0) or 0)
            gap += int(attrs.get("pool_gap", 0) or 0)
            enabled = enabled or bool(attrs.get("pool_enabled"))
        if not seen:
            print("cold-mount cause: unknown (no warm-pool outcome on "
                  "the scheduling span — pre-capacity worker?)")
        elif not enabled:
            print(f"cold-mount cause: scheduler wait ({gap} GPU(s) "
                  f"cold-created; warm pool disabled on this node)")
        elif gap > 0:
            print(f"cold-mount cause: warm-pool starvation ({gap} "
                  f"GPU(s) fell to the cold path, {hits} adopted "
                  f"warm — the pool ran dry)")
        else:
            print(f"cold-mount cause: scheduler wait ({hits} GPU(s) "
                  f"adopted warm yet scheduling still dominated)")
    if not payload.get("complete", False):
        orphans = payload.get("orphans") or []
        missing = payload.get("missing_worker_halves") or []
        print(f"INCOMPLETE assembly: {len(orphans)} orphan span(s), "
              f"{len(missing)} rpc span(s) missing their worker half — "
              f"the breakdown above understates remote phases",
              file=sys.stderr)
        return 3
    return 0


def cmd_timeline(args) -> int:
    """The incident flight recorder's merged chronological timeline (GET
    /timeline): root/error spans, audit records, k8s Events, ApiHealth
    transitions and recovery markers, oldest first. JSON on stdout; a
    one-line-per-record rendering on stderr for humans."""
    params = {k: v for k, v in (
        ("node", args.node), ("trace", args.trace), ("kind", args.kind),
        ("from", args.since), ("to", args.until),
        ("limit", str(args.limit))) if v}
    path = "/timeline" + (f"?{urllib.parse.urlencode(params)}"
                          if params else "")
    status, body = _http(args, "GET", path, token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        records = json.loads(body).get("records", [])
    except ValueError:
        return 1
    for rec in records:
        trace_id = rec.get("trace_id") or "-"
        node = rec.get("node") or "-"
        print(f"{rec.get('at', 0):.3f} [{rec.get('kind', '?'):>9}] "
              f"{node:<12} {rec.get('summary', '')} (trace {trace_id})",
              file=sys.stderr)
    return 0


def cmd_fleet(args) -> int:
    status, body = _http(args, "GET", "/fleet", token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        nodes = json.loads(body).get("nodes", {})
    except ValueError:
        return 1
    # Stale entries flagged on stderr (stdout stays parseable JSON): a
    # stale node's numbers describe the LAST successful collect.
    for name in sorted(nodes):
        entry = nodes[name]
        if entry.get("stale"):
            age = entry.get("stale_age_s")
            when = (f"last collected {age}s ago" if age is not None
                    else "NEVER collected successfully")
            print(f"STALE: node {name} {when} "
                  f"({entry.get('error', 'unreachable')})",
                  file=sys.stderr)
    return 0


def cmd_tenants(args) -> int:
    """The per-tenant disruption ledger (GET /tenants): every window a
    tenant's loop felt, attributed to its cause and joined to its
    control-plane trace. Exit 3 when any disruption window is still open."""
    status, body = _http(args, "GET", "/tenants", token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        return 1
    tenants = payload.get("tenants", {})
    if args.tenant:
        tenants = {k: v for k, v in tenants.items() if k == args.tenant}
        if not tenants:
            print(f"error: no tenant {args.tenant!r} in the ledger",
                  file=sys.stderr)
            return 2
    open_windows = 0
    for name in sorted(tenants):
        entry = tenants[name]
        dis = entry.get("disruption", {})
        open_windows += len(dis.get("open", []))
        causes = ", ".join(
            f"{cause}: {agg.get('windows', 0)}x p95 "
            f"{agg.get('p95_ms', 0)}ms"
            for cause, agg in sorted(dis.get("by_cause", {}).items()))
        print(f"tenant {name}: steps={entry.get('steps', 0)} "
              f"tokens/s={entry.get('tokens_per_s', 0)} "
              f"disrupted {dis.get('total_seconds', 0)}s over "
              f"{dis.get('total_windows', 0)} window(s)"
              + (f" [{causes}]" if causes else ""), file=sys.stderr)
        for w in dis.get("open", []):
            print(f"  OPEN: {w.get('cause')} for {w.get('age_s')}s "
                  f"(trace {w.get('trace_id') or '-'})", file=sys.stderr)
    return 3 if open_windows else 0


def cmd_capacity(args) -> int:
    """The capacity pane (GET /capacity): the fleet's GPU inventory, the
    per-host and fleet fragmentation indices, the per-shape feasibility
    table and the headroom forecast; the JSON keys are the reference's.
    JSON on stdout; one-line verdicts on stderr. Exit 2 when --accel-type
    names an unknown shape (the port's are topology.FEASIBILITY_SHAPES,
    nvidia-h100-80gb-1 to -256); exit 3 when that shape is infeasible right
    now, or (without --accel-type) when the declared intent demand no
    longer fits free capacity."""
    path = "/capacity"
    if args.accel_type:
        path += f"?accel_type={urllib.parse.quote(args.accel_type)}"
    status, body = _http(args, "GET", path, token=_obs_token(args))
    print(body.rstrip())
    if status == 404 and args.accel_type:
        return 2
    if status != 200:
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        return 1
    fleet = payload.get("fleet", {})
    print(f"fleet: {fleet.get('free', 0)}/{fleet.get('total', 0)} "
          f"GPU(s) free (warm {fleet.get('warm', 0)}, fenced "
          f"{fleet.get('fenced', 0)}), fragmentation index "
          f"{fleet.get('fragmentation_index', 0.0)}, largest block "
          f"{fleet.get('largest_block', 0)} across "
          f"{fleet.get('hosts_reporting', 0)}/{fleet.get('hosts', 0)} "
          f"reporting host(s)", file=sys.stderr)
    infeasible_requested = False
    for accel, entry in sorted((payload.get("feasibility") or {}).items()):
        verdict = entry.get("verdict", "?")
        line = (f"{accel}: {verdict} "
                f"({entry.get('hosts_admissible_now', 0)}/"
                f"{entry.get('hosts_needed', 0)} host(s) admissible "
                f"now, {entry.get('hosts_after_defrag', 0)} after "
                f"defrag)")
        blocking = entry.get("blocking_hosts") or []
        if blocking:
            line += f" blocking: {', '.join(blocking)}"
        print(line, file=sys.stderr)
        if args.accel_type and verdict == "infeasible":
            infeasible_requested = True
    headroom = payload.get("headroom", {})
    print(f"headroom: {headroom.get('forecast', '?')} "
          f"(free {headroom.get('free_chips', 0)}, queue depth "
          f"{headroom.get('queue_depth', 0)}, "
          f"{headroom.get('tokens_per_s', 0)} tokens/s across "
          f"{headroom.get('tenants', 0)} tenant(s))", file=sys.stderr)
    demand = payload.get("demand", {})
    if demand.get("intents") and not demand.get("satisfiable", True):
        print(f"DEMAND UNSATISFIABLE: declared intents want "
              f"{demand.get('gap', 0)} more GPU(s) than free+warm "
              f"capacity holds", file=sys.stderr)
        if not args.accel_type:
            return 3
    return 3 if infeasible_requested else 0


def cmd_apihealth(args) -> int:
    """The master's API-outage degraded-mode pane (GET /apihealth): the
    ApiHealth verdict (healthy/degraded/down), the store cache's staleness
    stamps and the write-behind queue. Exit 3 when the API is degraded or
    down, or deferred writes are still pending."""
    status, body = _http(args, "GET", "/apihealth",
                         token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        return 1
    api = payload.get("api", {})
    state = api.get("state", "unknown")
    pending = payload.get("store", {}).get("writeBehind", {}) \
        .get("pending", 0)
    print(f"api: {state} (for {api.get('sinceS', 0)}s, "
          f"{api.get('consecutiveFailures', 0)} consecutive failure(s))"
          + (f"; last error: {api.get('lastError')}"
             if api.get("lastError") and state != "healthy" else ""),
          file=sys.stderr)
    if pending:
        print(f"write-behind: {pending} deferred write(s) pending "
              f"replay", file=sys.stderr)
    return 3 if state != "healthy" or pending else 0


def cmd_shards(args) -> int:
    """The shard table: which master replica owns which shard."""
    status, body = _http(args, "GET", "/shards", token=_obs_token(args))
    print(body.rstrip())
    return 0 if status == 200 else 1


def cmd_recovery(args) -> int:
    """The recovery plane: per-node liveness verdicts + evacuation history
    (GET /recovery), or --evacuate NODE to trigger a manual evacuation
    (POST; the mutate token). Exit 3 when any node is suspect/evacuated."""
    if args.evacuate:
        status, body = _http(args, "POST",
                             f"/recovery/evacuate/{args.evacuate}",
                             token=_remote_token(args))
        print(body.rstrip())
        return 0 if status == 200 else 1
    status, body = _http(args, "GET", "/recovery", token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        nodes = json.loads(body).get("nodes", {})
    except ValueError:
        return 1
    unhealthy = any(entry.get("status") in ("suspect", "evacuated")
                    for entry in nodes.values())
    return 3 if unhealthy else 0


def cmd_health(args) -> int:
    """The gray-failure health plane: per-node scorer verdicts +
    quarantine states (GET /health/nodes), or --quarantine NODE /
    --release NODE to drive the state machine by hand (POST; the mutate
    token). A 409 refusal exits 2: the plane refused, nothing changed. Exit
    3 while ANY node is quarantined."""
    if args.quarantine or args.release:
        node = args.quarantine or args.release
        action = "quarantine" if args.quarantine else "release"
        body_json: dict = {"action": action}
        if args.quarantine and args.reason:
            body_json["reason"] = args.reason
        status, body = _http(args, "POST", f"/health/quarantine/{node}",
                             json_body=body_json,
                             token=_remote_token(args))
        print(body.rstrip())
        if status == 409:
            return 2
        return 0 if status == 200 else 1
    status, body = _http(args, "GET", "/health/nodes",
                         token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        return 1
    nodes = payload.get("nodes") or {}
    quarantined = any(entry.get("state") == "quarantined"
                      and not entry.get("evacuated")
                      for entry in nodes.values())
    return 3 if quarantined else 0


def cmd_defrag(args) -> int:
    """The defragmenter. No flag: the state pane (GET /defrag, exit 3 when
    the controller is gated: API degraded or an SLO burning). --plan
    computes and adopts a migration plan, --run executes the adopted plan,
    --pause stops after the in-flight move (all POST; the mutate token). A
    409/503 refusal exits 2: the controller refused, nothing moved."""
    if args.plan:
        body_json = ({"target_block": args.target_block}
                     if args.target_block else {})
        status, body = _http(args, "POST", "/defrag/plan",
                             json_body=body_json,
                             token=_remote_token(args))
    elif args.run:
        body_json = {"plan_id": args.plan_id} if args.plan_id else {}
        status, body = _http(args, "POST", "/defrag/run",
                             json_body=body_json,
                             token=_remote_token(args))
    elif args.pause:
        status, body = _http(args, "POST", "/defrag/pause",
                             json_body={}, token=_remote_token(args))
    else:
        status, body = _http(args, "GET", "/defrag",
                             token=_obs_token(args))
        print(body.rstrip())
        if status != 200:
            return 1
        try:
            gates = json.loads(body).get("gates", {})
        except ValueError:
            return 1
        gated = (not gates.get("api_ok", True)
                 or gates.get("slo_burning"))
        return 3 if gated else 0
    print(body.rstrip())
    if status in (409, 503):
        return 2
    return 0 if status == 200 else 1


def cmd_autoscale(args) -> int:
    """The autoscaler. No flag: the state pane (GET /autoscale: per-tenant
    throughput fits, gates, recent decisions; exit 3 when the controller is
    gated or paused). --pause parks it, --resume un-parks it, --evaluate
    forces one decision pass now (all POST; the mutate token). A 409/503
    refusal exits 2: the controller refused, nothing scaled."""
    if args.pause:
        status, body = _http(args, "POST", "/autoscale/pause",
                             json_body={}, token=_remote_token(args))
    elif args.resume:
        status, body = _http(args, "POST", "/autoscale/resume",
                             json_body={}, token=_remote_token(args))
    elif args.evaluate:
        status, body = _http(args, "POST", "/autoscale/evaluate",
                             json_body={}, token=_remote_token(args))
    else:
        status, body = _http(args, "GET", "/autoscale",
                             token=_obs_token(args))
        print(body.rstrip())
        if status != 200:
            return 1
        try:
            pane = json.loads(body)
        except ValueError:
            return 1
        gates = pane.get("gates", {})
        gated = (not gates.get("api_ok", True)
                 or gates.get("slo_burning")
                 or pane.get("paused"))
        return 3 if gated else 0
    print(body.rstrip())
    if status in (409, 503):
        return 2
    return 0 if status == 200 else 1


def cmd_shares(args) -> int:
    """Fractional GPU shares. No flag: the share books (GET /shares; exit 3
    when any GPU's booked load exceeds the weight capacity). --admit books
    shares for a tenant (--pod, --profile, --gpus, --weight, --rate-budget,
    candidate GPUs through repeated --gpu UUID=NODE; the body keeps the
    reference's keys "chips" and "inventory"); --release drops every share
    the tenant holds. A 409 admission refusal exits 2: the packer refused,
    nothing was booked."""
    if args.admit or args.release:
        if not args.pod:
            print("error: --pod is required with --admit/--release",
                  file=sys.stderr)
            return 2
    if args.admit:
        inventory = {}
        for raw in args.gpu:
            uuid, sep, node = raw.partition("=")
            if not sep or not uuid or not node:
                print(f"error: bad --gpu {raw!r} (want UUID=NODE)",
                      file=sys.stderr)
                return 2
            inventory[uuid] = node
        status, body = _http(
            args, "POST", "/shares",
            json_body={"namespace": args.namespace, "pod": args.pod,
                       "profile": args.profile, "chips": args.gpus,
                       "weight": args.weight,
                       "rate_budget": args.rate_budget,
                       "inventory": inventory},
            token=_remote_token(args))
        print(body.rstrip())
        if status == 409:
            return 2
        return 0 if status == 200 else 1
    if args.release:
        status, body = _http(
            args, "DELETE",
            f"/shares/{urllib.parse.quote(args.namespace)}/"
            f"{urllib.parse.quote(args.pod)}",
            token=_remote_token(args))
        print(body.rstrip())
        return 0 if status == 200 else 1
    status, body = _http(args, "GET", "/shares", token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        return 1
    capacity = payload.get("weight_capacity", 0)
    overbooked = False
    for uuid, entry in sorted((payload.get("chips") or {}).items()):
        line = (f"{uuid} on {entry.get('node', '?')}: "
                f"{entry.get('tenants', 0)} tenant(s), load "
                f"{entry.get('load', 0)}/{capacity} "
                f"[{', '.join(entry.get('profiles') or [])}]")
        if capacity and entry.get("load", 0) > capacity:
            line += " OVERBOOKED"
            overbooked = True
        print(line, file=sys.stderr)
    totals = payload.get("totals", {})
    print(f"{totals.get('shares', 0)} share(s) over "
          f"{totals.get('chips', 0)} GPU(s), "
          f"{totals.get('shared_chips', 0)} co-located", file=sys.stderr)
    return 3 if overbooked else 0


def _parse_bulk_target(raw: str, default_ns: str) -> dict:
    """"[ns/]pod[:gpus]" -> a /batch/addgpu target entry; the port's master
    reads the count under "gpus" (master/app.py)."""
    body, _, gpus = raw.partition(":")
    ns, _, pod = body.rpartition("/")
    entry = {"namespace": ns or default_ns, "pod": pod or body}
    if gpus:
        try:
            entry["gpus"] = int(gpus)
        except ValueError:
            raise SystemExit(f"error: bad --target {raw!r} "
                             f"(GPUs must be an integer)")
    return entry


def cmd_bulk_add(args) -> int:
    """One request, many mounts: exit 0 only when EVERY target mounted
    (per-target results are printed either way)."""
    targets = [_parse_bulk_target(t, args.namespace)
               for t in args.target]
    if args.entire:
        for t in targets:
            t["isEntireMount"] = True
    status, body = _http(args, "POST", "/batch/addgpu",
                         json_body={"targets": targets},
                         token=_remote_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        summary = json.loads(body).get("summary", {})
    except ValueError:
        return 1
    return 0 if summary.get("success") == summary.get("total") else 1


def cmd_slo(args) -> int:
    """Print the SLO evaluation; exit 3 when any objective is in breach (a
    deploy gate can run `slo && roll`). Besides the raw JSON, each
    objective gets a one-line verdict naming its fast/slow burn against
    their windows and the breach threshold."""
    status, body = _http(args, "GET", "/slo", token=_obs_token(args))
    print(body.rstrip())
    if status != 200:
        return 1
    try:
        payload = json.loads(body)
    except ValueError:
        return 1
    windows = payload.get("windows_s", {})
    fast_s, slow_s = windows.get("fast", 0), windows.get("slow", 0)
    threshold = payload.get("burn_threshold", 0)
    breached = False
    for obj in payload.get("objectives", []):
        burn_fast = obj.get("burn_fast", 0.0)
        burn_slow = obj.get("burn_slow", 0.0)
        if obj.get("breached"):
            breached = True
            verdict = "BREACH (both windows over threshold)"
        elif burn_fast >= threshold > burn_slow:
            verdict = "ok (fast window hot, slow window holding)"
        elif burn_slow >= threshold > burn_fast:
            verdict = "ok (slow window elevated, fast window calm)"
        else:
            verdict = "ok"
        print(f"{obj.get('name')}: burn {burn_fast:.2f}x/{fast_s:.0f}s "
              f"(fast) {burn_slow:.2f}x/{slow_s:.0f}s (slow), "
              f"threshold {threshold:.1f}x -> {verdict}",
              file=sys.stderr)
    return 3 if breached else 0


EXIT_OK = 0
EXIT_ERROR = 1
EXIT_REJECTED = 2    # 4xx: bad request, nothing moved
EXIT_FAILED = 3      # migration went terminal without succeeding


def _terminal_exit(journal: dict) -> int:
    return EXIT_OK if journal.get("outcome") == "succeeded" else EXIT_FAILED


def cmd_migrate_start(args) -> int:
    import time

    payload = {
        "source": {"namespace": args.namespace, "pod": args.pod},
        "destination": {"namespace": args.dest_namespace or args.namespace,
                        "pod": args.dest_pod},
        "checkpoint": bool(args.checkpoint),
    }
    token = _remote_token(args)
    status, body = _http(args, "POST", "/migrate",
                         json_body=payload, token=token)
    print(body.rstrip())
    if 400 <= status < 500:
        return EXIT_REJECTED
    if status != 200:
        return EXIT_ERROR
    if not args.wait:
        return EXIT_OK
    mid = json.loads(body)["id"]
    endpoints = _endpoints(args, token)
    deadline = time.monotonic() + args.wait_timeout
    while time.monotonic() < deadline:
        # A failed poll (every replica restarting, a blip) does not end
        # the wait: the journal lives in pod annotations and a restarted
        # or peer master adopts the migration, so poll until the deadline.
        try:
            status, body = endpoints.request("GET", f"/migrations/{mid}")
        except (urllib.error.URLError, OSError):
            status = None
        if status == 200:
            journal = json.loads(body)
            if journal.get("outcome"):
                print(json.dumps(journal, indent=1))
                return _terminal_exit(journal)
        time.sleep(args.poll_interval)
    print(f"error: migration {mid} not terminal within "
          f"{args.wait_timeout}s", file=sys.stderr)
    return EXIT_ERROR


def _print_phase_durations(journal: dict) -> None:
    """One stderr line per terminal migration naming where the wall time
    went: the journal's per-phase durations, the numbers the
    defragmenter's cost model reads."""
    durations = journal.get("phase_durations_s")
    if not durations or not journal.get("outcome"):
        return
    rendered = " ".join(f"{phase}={seconds:.2f}s"
                        for phase, seconds in durations.items())
    total = sum(durations.values())
    print(f"{journal.get('id')}: {journal.get('outcome')} in "
          f"{total:.2f}s ({rendered})", file=sys.stderr)


def cmd_migrate_status(args) -> int:
    path = f"/migrations/{args.id}" if args.id else "/migrations"
    status, body = _http(args, "GET", path, token=_remote_token(args))
    print(body.rstrip())
    if 400 <= status < 500:
        return EXIT_REJECTED
    if status != 200:
        return EXIT_ERROR
    try:
        payload = json.loads(body)
    except ValueError:
        return EXIT_OK
    for journal in (payload.get("migrations", [])
                    if args.id is None else [payload]):
        _print_phase_durations(journal)
    return EXIT_OK


def cmd_migrate_abort(args) -> int:
    status, body = _http(args, "POST", f"/migrations/{args.id}/abort",
                         token=_remote_token(args))
    print(body.rstrip())
    if 400 <= status < 500:
        return EXIT_REJECTED
    return EXIT_OK if status == 200 else EXIT_ERROR


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpumounter")
    sub = p.add_subparsers(dest="verb", required=True)

    d = sub.add_parser("devices", help="list GPU inventory")
    d.add_argument("--busy", action="store_true",
                   help="include holder PIDs per GPU")
    d.set_defaults(fn=cmd_devices)

    pr = sub.add_parser("probe", help="identity source / NVML / cgroup / "
                                      "namespace helper")
    pr.set_defaults(fn=cmd_probe)

    def _local_args(sp):
        sp.add_argument("--target-dev", required=True,
                        help="device dir of the target (its /dev)")
        sp.add_argument("--pid", type=int, default=None,
                        help="PID whose mount namespace to enter")
        sp.add_argument("--cgroup", default="",
                        help="target cgroup dir for device permission")

    m = sub.add_parser("mount", help="local mount (no k8s)")
    _local_args(m)
    m.add_argument("--gpus", type=int, default=1)
    m.add_argument("--uuid", action="append", default=[])
    m.set_defaults(fn=cmd_mount)

    um = sub.add_parser("unmount", help="local unmount (no k8s)")
    _local_args(um)
    um.add_argument("--uuid", action="append", required=True)
    um.add_argument("--force", action="store_true")
    um.set_defaults(fn=cmd_unmount)

    a = sub.add_parser("add", help="hot-add via a running master")
    a.add_argument("--master", required=True,
                   help="master URL, or a comma-separated replica list "
                        "(failover + shard-redirect following)")
    a.add_argument("--namespace", default="default")
    a.add_argument("--pod", required=True)
    a.add_argument("--num", type=int, default=1)
    a.add_argument("--entire", action="store_true")
    a.add_argument("--token", default=None,
                   help="master bearer token (default: "
                        "TPUMOUNTER_AUTH_TOKEN[_FILE])")
    a.set_defaults(fn=cmd_add)

    # Bulk mount: one POST /batch/addgpu covering many pods; the master
    # groups targets by owning shard and node.
    ba = sub.add_parser("bulk-add", help="mount GPUs into MANY pods in "
                                         "one request")
    ba.add_argument("--master", required=True,
                    help="master URL, or a comma-separated replica list")
    ba.add_argument("--namespace", default="default",
                    help="default namespace for --target entries")
    ba.add_argument("--target", action="append", required=True,
                    metavar="[NS/]POD[:GPUS]",
                    help="repeatable; e.g. --target serve-a:2 "
                         "--target jobs/serve-b")
    ba.add_argument("--entire", action="store_true",
                    help="entire-mount each target's GPUs")
    ba.add_argument("--token", default=None,
                    help="master bearer token (default: "
                         "TPUMOUNTER_AUTH_TOKEN[_FILE])")
    ba.set_defaults(fn=cmd_bulk_add)

    # Elastic intents: declare desired GPU counts; the master's reconciler
    # converges and keeps converging (self-healing).
    it = sub.add_parser("intent", help="declarative GPU-count intents")
    it_sub = it.add_subparsers(dest="intent_verb", required=True)

    def _intent_common(sp, with_pod=True):
        sp.add_argument("--master", required=True)
        if with_pod:
            sp.add_argument("--namespace", default="default")
            sp.add_argument("--pod", required=True)
        sp.add_argument("--token", default=None,
                        help="master bearer token (default: "
                             "TPUMOUNTER_AUTH_TOKEN[_FILE])")

    iset = it_sub.add_parser("set", help="declare desired GPUs for a pod")
    _intent_common(iset)
    iset.add_argument("--gpus", type=int, required=True,
                      help="desired GPU count the reconciler converges to")
    iset.add_argument("--min-gpus", type=int, default=0,
                      help="acceptable floor under capacity pressure")
    iset.add_argument("--priority", type=int, default=0,
                      help="higher reconciles first when contended")
    iset.set_defaults(fn=cmd_intent_set)

    iget = it_sub.add_parser("get", help="show one pod's intent + status")
    _intent_common(iget)
    iget.set_defaults(fn=cmd_intent_get)

    idel = it_sub.add_parser("delete",
                             help="stop managing a pod (keeps its GPUs)")
    _intent_common(idel)
    idel.set_defaults(fn=cmd_intent_delete)

    ilist = it_sub.add_parser("list", help="all declared intents")
    _intent_common(ilist, with_pod=False)
    ilist.set_defaults(fn=cmd_intent_list)

    # Live migration: drain, snapshot, and re-mount a tenant's GPU set on
    # another pod without restarting the tenant.
    mg = sub.add_parser("migrate", help="live GPU migration between pods")
    mg_sub = mg.add_subparsers(dest="migrate_verb", required=True)

    def _migrate_common(sp):
        sp.add_argument("--master", required=True)
        sp.add_argument("--token", default=None,
                        help="master bearer token (default: "
                             "TPUMOUNTER_AUTH_TOKEN[_FILE])")

    ms = mg_sub.add_parser("start", help="migrate a pod's GPUs to "
                                         "another pod")
    _migrate_common(ms)
    ms.add_argument("--namespace", default="default")
    ms.add_argument("--pod", required=True, help="source pod")
    ms.add_argument("--dest-namespace", default=None,
                    help="destination namespace (default: --namespace)")
    ms.add_argument("--dest-pod", required=True, help="destination pod")
    ms.add_argument("--checkpoint", action="store_true",
                    help="checkpoint-assisted drain: snapshot tenant "
                         "state before the GPUs move so the drain window "
                         "shrinks to a copy")
    ms.add_argument("--wait", action="store_true",
                    help="block until the migration is terminal")
    ms.add_argument("--wait-timeout", type=float, default=300.0)
    ms.add_argument("--poll-interval", type=float, default=0.5)
    ms.set_defaults(fn=cmd_migrate_start)

    mst = mg_sub.add_parser("status", help="one migration (--id) or all")
    _migrate_common(mst)
    mst.add_argument("--id", default=None)
    mst.set_defaults(fn=cmd_migrate_status)

    mab = mg_sub.add_parser("abort", help="abort an in-flight migration "
                                          "(rolls back to the source)")
    _migrate_common(mab)
    mab.add_argument("--id", required=True)
    mab.set_defaults(fn=cmd_migrate_abort)

    # Observability reads: what happened to a pod's GPUs, when, and why
    # was it slow.
    def _obs_common(sp):
        sp.add_argument("--master", required=True)
        sp.add_argument("--token", default=None,
                        help="master bearer token (default: "
                             "TPUMOUNTER_AUTH_TOKEN[_FILE])")
        sp.add_argument("--read-token", default=None,
                        help="read-only observability token "
                             "(TPUMOUNTER_AUTH_READ_TOKEN scope)")

    au = sub.add_parser("audit", help="query the mutating-operation "
                                      "audit trail")
    _obs_common(au)
    au.add_argument("--namespace", default=None)
    au.add_argument("--pod", default=None)
    au.add_argument("--op", default=None,
                    help="operation prefix (http., worker., migrate...)")
    au.add_argument("--trace", default=None, help="exact trace id")
    au.add_argument("--outcome", default=None,
                    help="outcome prefix (Success, error, http 4...)")
    au.add_argument("--limit", type=int, default=100)
    au.set_defaults(fn=cmd_audit)

    tr = sub.add_parser("trace", help="dump all buffered spans for one "
                                      "trace id")
    _obs_common(tr)
    tr.add_argument("id", help="trace id (X-Tpumounter-Trace response "
                               "header / audit record trace_id)")
    tr.set_defaults(fn=cmd_trace)

    wy = sub.add_parser("why", help="name the dominant critical-path "
                                    "phase of one trace (exit 3 when "
                                    "the assembly is incomplete)")
    _obs_common(wy)
    wy.add_argument("id", help="trace id (X-Tpumounter-Trace response "
                               "header / audit record trace_id)")
    wy.set_defaults(fn=cmd_why)

    tl = sub.add_parser("timeline", help="incident flight recorder: the "
                                         "merged chronological timeline "
                                         "(spans, audit, Events, "
                                         "ApiHealth, recovery markers)")
    _obs_common(tl)
    tl.add_argument("--node", default=None, help="only this node")
    tl.add_argument("--trace", default=None, help="only this trace id")
    tl.add_argument("--kind", default=None,
                    help="span / audit / event / apihealth / recovery")
    tl.add_argument("--since", dest="since", default=None, metavar="FROM",
                    help="unix-seconds lower bound (?from=)")
    tl.add_argument("--until", dest="until", default=None, metavar="TO",
                    help="unix-seconds upper bound (?to=)")
    tl.add_argument("--limit", type=int, default=500)
    tl.set_defaults(fn=cmd_timeline)

    fl = sub.add_parser("fleet", help="federated fleet rollup: per-node "
                                      "mount p50/p95, warm-pool hit "
                                      "rate, breaker state")
    _obs_common(fl)
    fl.set_defaults(fn=cmd_fleet)

    sl = sub.add_parser("slo", help="SLO burn-rate evaluation (exit 3 "
                                    "when any objective is in breach)")
    _obs_common(sl)
    sl.set_defaults(fn=cmd_slo)

    tn = sub.add_parser("tenants", help="per-tenant disruption ledger: "
                                        "step rates, downtime windows "
                                        "attributed to their cause + "
                                        "trace (exit 3 when any window "
                                        "is still open)")
    _obs_common(tn)
    tn.add_argument("--tenant", default=None,
                    help="show only this tenant (exit 2 when absent)")
    tn.set_defaults(fn=cmd_tenants)

    sh = sub.add_parser("shards", help="shard table: which master "
                                       "replica owns which node shard")
    _obs_common(sh)
    sh.set_defaults(fn=cmd_shards)

    cp = sub.add_parser("capacity",
                        help="capacity pane: fleet GPU inventory, "
                             "fragmentation index, per-shape feasibility "
                             "+ headroom forecast (exit 3 when "
                             "--accel-type is infeasible or declared "
                             "demand no longer fits)")
    _obs_common(cp)
    cp.add_argument("--accel-type", default=None,
                    help="only this shape's feasibility (e.g. "
                         "nvidia-h100-80gb-8; exit 2 when unknown, "
                         "3 when infeasible)")
    cp.set_defaults(fn=cmd_capacity)

    ah = sub.add_parser("apihealth",
                        help="API-outage degraded mode: ApiHealth "
                             "verdict + cache staleness + write-behind "
                             "queue (exit 3 when not healthy or writes "
                             "are pending)")
    _obs_common(ah)
    ah.set_defaults(fn=cmd_apihealth)

    rc = sub.add_parser("recovery", help="node-failure recovery plane: "
                                         "liveness verdicts + evacuation "
                                         "history (exit 3 when any node "
                                         "is suspect/evacuated)")
    _obs_common(rc)
    rc.add_argument("--evacuate", metavar="NODE", default=None,
                    help="manually evacuate NODE (operator-confirmed "
                         "death; needs the mutate token)")
    rc.set_defaults(fn=cmd_recovery)

    hl = sub.add_parser("health",
                        help="gray-failure health plane: per-node "
                             "scorer verdicts + quarantine states "
                             "(no flag: pane, exit 3 while any node is "
                             "quarantined; --quarantine/--release "
                             "mutate, exit 2 on a plane refusal)")
    _obs_common(hl)
    hl_group = hl.add_mutually_exclusive_group()
    hl_group.add_argument("--quarantine", metavar="NODE", default=None,
                          help="manually quarantine NODE (budget-exempt; "
                               "needs the mutate token)")
    hl_group.add_argument("--release", metavar="NODE", default=None,
                          help="release NODE straight to healthy "
                               "(needs the mutate token)")
    hl.add_argument("--reason", default=None,
                    help="with --quarantine: why (lands in the pane and "
                         "the flight recorder)")
    hl.set_defaults(fn=cmd_health)

    df = sub.add_parser("defrag",
                        help="defragmenter: recover whole-host capacity "
                             "by live-migrating tenants off fragmented "
                             "hosts (no flag: state pane, exit 3 when "
                             "gated; --plan/--run/--pause mutate, exit 2 "
                             "on a controller refusal)")
    _obs_common(df)
    group = df.add_mutually_exclusive_group()
    group.add_argument("--plan", action="store_true",
                       help="compute + adopt a plan from a fresh "
                            "capacity snapshot")
    group.add_argument("--run", action="store_true",
                       help="execute the adopted plan")
    group.add_argument("--pause", action="store_true",
                       help="stop after the in-flight move")
    df.add_argument("--target-block", type=int, default=None,
                    help="block size to recover (default: "
                         "DEFRAG_TARGET_BLOCK)")
    df.add_argument("--plan-id", default=None,
                    help="with --run: refuse unless this exact plan "
                         "is still adopted")
    df.set_defaults(fn=cmd_defrag)

    asc = sub.add_parser("autoscale",
                         help="closed-loop autoscaler: per-tenant "
                              "throughput fits + gated grow/shrink "
                              "decisions on elastic intents (no flag: "
                              "state pane, exit 3 when gated or "
                              "paused; --pause/--resume/--evaluate "
                              "mutate, exit 2 on a controller refusal)")
    _obs_common(asc)
    asc_group = asc.add_mutually_exclusive_group()
    asc_group.add_argument("--pause", action="store_true",
                           help="park the decision loop (passes still "
                                "observe; nothing actuates)")
    asc_group.add_argument("--resume", action="store_true",
                           help="un-park the decision loop")
    asc_group.add_argument("--evaluate", action="store_true",
                           help="force one decision pass now")
    asc.set_defaults(fn=cmd_autoscale)

    vs = sub.add_parser("shares",
                        help="fractional GPU shares: the co-location "
                             "books (no flag: state pane, exit 3 when "
                             "any GPU is over its weight capacity; "
                             "--admit/--release mutate, exit 2 on an "
                             "admission refusal)")
    _obs_common(vs)
    vs_group = vs.add_mutually_exclusive_group()
    vs_group.add_argument("--admit", action="store_true",
                          help="book fractional shares for a tenant "
                               "(needs --pod; mutate token)")
    vs_group.add_argument("--release", action="store_true",
                          help="release every share a tenant holds "
                               "(needs --pod; mutate token)")
    vs.add_argument("--namespace", default="default")
    vs.add_argument("--pod", default=None)
    vs.add_argument("--profile", default="balanced",
                    help="tenant serving profile: prefill, decode or "
                         "balanced (complementary profiles co-locate "
                         "first)")
    vs.add_argument("--gpus", type=int, default=1,
                    help="how many GPUs to take a share of")
    vs.add_argument("--weight", type=int, default=50,
                    help="QoS weight per GPU (1..VCHIP_WEIGHT_CAPACITY)")
    vs.add_argument("--rate-budget", type=int, default=0,
                    help="device-access token budget per GPU "
                         "(0 = unmetered)")
    vs.add_argument("--gpu", action="append", default=[],
                    metavar="UUID=NODE",
                    help="candidate GPU for --admit (repeatable); the "
                         "packer also considers already-shared GPUs")
    vs.set_defaults(fn=cmd_shares)

    r = sub.add_parser("remove", help="hot-remove via a running master")
    r.add_argument("--master", required=True)
    r.add_argument("--namespace", default="default")
    r.add_argument("--pod", required=True)
    r.add_argument("--uuids", required=True, help="comma-separated")
    r.add_argument("--force", action="store_true")
    r.add_argument("--token", default=None,
                   help="master bearer token (default: "
                        "TPUMOUNTER_AUTH_TOKEN[_FILE])")
    r.set_defaults(fn=cmd_remove)
    return p


def main(argv: list[str] | None = None) -> int:
    init_logger()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
