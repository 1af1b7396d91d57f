"""Multi-host slices on the reference's stack and on the port's.

Both stacks are 4 fake nodes of 4 accelerators, a real gRPC worker a node
and the master's coordinator over them (``tests/torch_slice_stacks.py``).
Each scenario of ``tests/test_slice.py`` that is not TPU geometry runs on
both and records HTTP codes or ``SliceError`` statuses, messages (TPU read as
GPU), free counts by node and what each container sees; the records must be
equal. Then what the reference's file does not cover: an open breaker (503
with Retry-After), the rollback after a transport failure in both branches,
the keys of the rollback's calls, and the H100 plan: its shapes, its
refusals and each worker's ``torch.distributed`` env.
"""

from __future__ import annotations

import threading

import pytest
from torch_slice_stacks import NODES, PER_NODE, build_stacks

from gpumounter_tpu_torch.master.slice_ops import SliceError, SliceTarget, topology_plan
from gpumounter_tpu_torch.rpc import client as port_client
from gpumounter_tpu_torch.utils.fanout import reset_core


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    reset_core()
    made = build_stacks(str(tmp_path_factory.mktemp("slice")))
    yield made
    for stack in made.values():
        stack.close()
    reset_core()


def _pods(stack, tag: str, n: int = len(NODES)):
    return [(stack.add_pod(f"{tag}-{i}", NODES[i]), stack.target(f"{tag}-{i}"))
            for i in range(n)]


def _clear(stack, names) -> None:
    """Remove whatever each pod still holds, on every node."""
    for node in NODES:
        with stack.client(node) as client:
            for name in names:
                stack.remove(client, name, [], force=True, remove_all=True)


def _failure(fn) -> tuple:
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded for comparison
        from torch_slice_stacks import gpu_words
        return type(exc).__name__, getattr(exc, "status", None), gpu_words(str(exc))
    return None


def _squat(stack, node: str, tag: str) -> str:
    stack.add_pod(f"{tag}-squatter", node)
    with stack.client(node) as client:
        assert stack.add(client, f"{tag}-squatter", PER_NODE)[0] == "Success"
    return f"{tag}-squatter"


# --- the scenarios of tests/test_slice.py ---

def all_hosts_then_removed(s, tag):
    pods = _pods(s, tag)
    plan = s.mount_slice([t for _, t in pods], PER_NODE)
    record = [plan["slice"]["num_hosts"], [w["pod"] for w in plan["workers"]],
              [w["node"] for w in plan["workers"]], s.free_by_node(),
              [s.visible(n) for n in NODES]]
    out = s.slice_coordinator().remove_slice([t for _, t in pods], force=True)
    return record + [out, s.free_by_node(), [s.visible(n) for n in NODES]]


def all_or_nothing(s, tag):
    squatter = _squat(s, "host-2", tag)
    pods = _pods(s, tag)
    record = [_failure(lambda: s.mount_slice([t for _, t in pods], PER_NODE)),
              s.free_by_node()]
    _clear(s, [squatter])
    return record + [s.free_by_node()]


def single_mount_round_trip_and_rollback(s, tag):
    pods = _pods(s, tag)
    plan = s.mount_slice([t for _, t in pods], 2, entire=False)
    record = [plan["workers"][-1]["node"], s.free_by_node(),
              s.slice_coordinator().remove_slice([t for _, t in pods], force=True),
              s.free_by_node()]
    squatter = _squat(s, "host-3", tag)
    record += [_failure(lambda: s.mount_slice([t for _, t in pods], 2, entire=False)),
               s.free_by_node()]
    _clear(s, [squatter])
    return record


def insufficient_is_503(s, tag):
    pods = _pods(s, tag)
    hog = _squat(s, "host-1", tag)
    record = [_failure(lambda: s.mount_slice([t for _, t in pods], PER_NODE)),
              s.free_by_node()]
    _clear(s, [hog])
    return record


def distinct_nodes(s, tag):
    s.add_pod(f"{tag}-a", "host-0")
    s.add_pod(f"{tag}-b", "host-0")
    return [_failure(lambda: s.mount_slice([s.target(f"{tag}-a"), s.target(f"{tag}-b")], 1)),
            s.free_by_node()]


def resolve_refusals(s, tag):
    """Each check of the resolve, in its order: no pod (404), a pod without
    an IP (400), a node without a worker (500), and an empty slice (400)."""
    s.kube.create_pod("default", {"metadata": {"name": f"{tag}-noip", "namespace": "default"},
                                  "spec": {"nodeName": "host-0", "containers": [{"name": "m"}]},
                                  "status": {"phase": "Running"}})
    s.kube.create_pod("default", {"metadata": {"name": f"{tag}-lost", "namespace": "default"},
                                  "spec": {"nodeName": "no-such-node",
                                           "containers": [{"name": "m"}]},
                                  "status": {"phase": "Running", "podIP": "10.9.9.9"}})
    return [_failure(lambda: s.mount_slice([s.target(f"{tag}-ghost")], 1)),
            _failure(lambda: s.mount_slice([s.target(f"{tag}-noip")], 1)),
            _failure(lambda: s.mount_slice([s.target(f"{tag}-lost")], 1)),
            _failure(lambda: s.mount_slice([], 1)), s.free_by_node()]


def slice_http_routes(s, tag):
    _pods(s, tag)
    pods = [{"namespace": "default", "pod": f"{tag}-{i}"} for i in range(len(NODES))]
    status, plan, _ = s.post("/addslice", {"pods": pods, "chipsPerHost": PER_NODE,
                                           "gpusPerHost": PER_NODE})
    record = [status, plan["slice"]["num_hosts"], [w["address"] for w in plan["workers"]] == [
        s.kube.get_pod("default", p["pod"])["status"]["podIP"] for p in pods], s.free_by_node()]
    record.append(s.post("/removeslice", {"pods": pods, "force": True})[:2])
    record.append(s.free_by_node())
    for bad in ({}, {"pods": []}, {"pods": ["x"]}, {"pods": [{"namespace": "default"}]},
                {"pods": pods, "chipsPerHost": 0, "gpusPerHost": 0},
                {"pods": pods, "chipsPerHost": "many", "gpusPerHost": "many"}):
        record.append(s.post("/addslice", bad)[:2])
    record.append(s.post("/addslice", None, raw=b"not json")[:2])
    record.append(s.post("/removeslice", {"pods": [{"pod": f"{tag}-ghost"}]})[:2])
    return record


SCENARIOS = [all_hosts_then_removed, all_or_nothing, single_mount_round_trip_and_rollback,
             insufficient_is_503, distinct_nodes, resolve_refusals, slice_http_routes]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(stacks, scenario):
    tag = scenario.__name__.replace("_", "-")[:20]
    records = {name: scenario(stack, tag) for name, stack in stacks.items()}
    assert records["port"] == records["reference"]
    for stack in stacks.values():
        assert stack.free() == len(NODES) * PER_NODE, "a scenario left GPUs booked"


def test_a_bad_type_is_refused_before_anything_is_mounted(stacks):
    """An unknown acceleratorType and a type whose host shape the request
    does not fit: 400 on both masters (their tables differ: TPU slices,
    the H100 host), nothing mounted by either."""
    records = {}
    for name, stack in stacks.items():
        pods = [t for _, t in _pods(stack, "badtype")]
        fits = "v5litepod-16" if name == "reference" else "nvidia-h100-80gb"
        records[name] = [_failure(lambda: stack.mount_slice(pods, PER_NODE, accel="v9000"))[1],
                         _failure(lambda: stack.mount_slice(pods, 1, accel=fits))[1],
                         stack.free_by_node()]
    assert records["port"] == records["reference"] == [
        400, 400, {n: PER_NODE for n in NODES}]


# --- beyond tests/test_slice.py ---

def test_an_open_breaker_answers_503_with_retry_after(stacks):
    """A host whose breaker is open: the slice fails fast with 503 and
    Retry-After, the other hosts are rolled back, on both masters alike."""
    records = {}
    for name, stack in stacks.items():
        _pods(stack, "breaker")
        breaker = stack.breaker(failure_threshold=1, reset_s=60.0)
        blocked = stack.local("host-1")
        breaker.record_failure(blocked)

        def factory(address, stack=stack, breaker=breaker):
            node = NODES[int(address.split(":")[0].rsplit(".", 1)[1]) - 1]  # 10.0.0.<i + 1>
            return stack.client(node, breaker=breaker)

        app = stack.make_app(factory=factory)
        status, text, headers = stack.post("/addslice", {
            "pods": [{"pod": f"breaker-{i}"} for i in range(len(NODES))],
            "chipsPerHost": 1, "gpusPerHost": 1}, app=app)
        assert 55 <= int(headers["Retry-After"]) <= 60
        records[name] = [status, text.split(":")[0], stack.free_by_node()]
    assert records["port"] == records["reference"]
    assert records["port"][0] == 503 and records["port"][1] == "slice mount failed (breaker-1"


@pytest.mark.parametrize("entire", [True, False], ids=["entire", "single"])
def test_the_transport_rollback_matches_the_reference(stacks, entire):
    """A worker that mounts and then loses the call (WorkerUnavailableError
    after the mount landed): for an entire mount the empty-UUID forced remove
    frees that host too; for a single mount the reference leaves the host's
    GPUs mounted (it cannot tell them from earlier ones) and so does the
    port. Every host that answered is rolled back either way."""
    records = {}
    tag = "tr-entire" if entire else "tr-single"
    for name, stack in stacks.items():
        pods = [t for _, t in _pods(stack, tag)]

        def factory(address, stack=stack):
            real = stack.factory(address)
            if not address.startswith("10.0.0.3:"):  # host-2's worker
                return real
            method = getattr(real, stack.add_method())

            def mount_then_die(*args, **kwargs):
                method(*args, **kwargs)
                raise stack.unavailable("connection reset after the mount")

            setattr(real, stack.add_method(), mount_then_die)
            return real

        failure = _failure(lambda: stack.mount_slice(pods, 2, entire=entire, factory=factory))
        records[name] = [failure, stack.free_by_node(), [stack.visible(n) for n in NODES]]
        _clear(stack, [t.pod for t in pods])
    assert records["port"] == records["reference"]
    assert records["port"][0][:2] == ("SliceError", 500)
    leaked = 0 if entire else 2
    assert records["port"][1] == {n: PER_NODE - (leaked if n == "host-2" else 0) for n in NODES}


def test_every_call_of_a_rolled_back_slice_has_its_own_key(stacks, monkeypatch):
    """The client retries a mutation under one idempotency key; a rollback's
    remove must not reuse its add's key (the worker would replay the add's
    answer instead of removing)."""
    stack = stacks["port"]
    keys = []
    lock = threading.Lock()
    real_call = port_client.WorkerClient._call

    def recording(self, method, request):
        with lock:
            keys.append((method, request.idempotency_key))
        return real_call(self, method, request)

    monkeypatch.setattr(port_client.WorkerClient, "_call", recording)
    squatter = _squat(stack, "host-0", "keys")
    pods = [t for _, t in _pods(stack, "keys")]
    with pytest.raises(SliceError):
        stack.mount_slice(pods, 1)
    _clear(stack, [squatter])
    slice_keys = keys[1:1 + 2 * (len(NODES) - 1) + 1]
    assert sorted(m for m, _ in slice_keys) == ["AddGPU"] * len(NODES) + ["RemoveGPU"] * (
        len(NODES) - 1)
    assert len({k for _, k in keys}) == len(keys)


# --- the H100 plan ---

def _targets(n):
    return [SliceTarget("default", f"rank-{i}") for i in range(n)]


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_the_h100_plan_of_whole_hosts(hosts):
    ips = [f"10.8.{i}.2" for i in range(hosts)]
    plan = topology_plan(_targets(hosts), [f"host-{i}" for i in range(hosts)], ips, 8,
                         accel_type="nvidia-h100-80gb")
    shared = {"MASTER_ADDR": ips[0], "NNODES": str(hosts), "NPROC_PER_NODE": "8",
              "WORLD_SIZE": str(8 * hosts), "ACCELERATOR_TYPE": "nvidia-h100-80gb"}
    assert plan["slice"] == {"num_hosts": hosts, "total_gpus": 8 * hosts,
                             "layout": "nvidia-h100-80gb", **shared}
    assert plan["workers"] == [
        {"namespace": "default", "pod": f"rank-{i}", "node": f"host-{i}", "address": ips[i],
         "env": {"NODE_RANK": str(i), **shared}} for i in range(hosts)]
    # the global ranks of the world cover 0..WORLD_SIZE-1 once each
    ranks = sorted(int(w["env"]["NODE_RANK"]) * 8 + local
                   for w in plan["workers"] for local in range(8))
    assert ranks == list(range(8 * hosts))


@pytest.mark.parametrize("hosts, per_host, message", [
    (3, 4, "12 GPUs of nvidia-h100-80gb are not a whole number of hosts of 8"),
    (2, 4, "nvidia-h100-80gb spans 1 host(s) but 2 pod(s) were given"),
    (1, 16, "nvidia-h100-80gb spans 2 host(s) but 1 pod(s) were given"),
    (2, 8, None),
])
def test_the_h100_plan_refuses_what_is_not_its_shape(hosts, per_host, message):
    """A 12-GPU request, a 4-GPU host and a 16-GPU host under the named type
    answer 400; 2 x 8 is the type's own shape."""
    args = (_targets(hosts), [f"h{i}" for i in range(hosts)],
            [f"10.0.0.{i}" for i in range(hosts)], per_host)
    if message is None:
        assert topology_plan(*args, accel_type="nvidia-h100-80gb")["slice"]["num_hosts"] == 2
        return
    with pytest.raises(SliceError) as exc:
        topology_plan(*args, accel_type="nvidia-h100-80gb")
    assert (exc.value.status, str(exc.value)) == (400, message)
    with pytest.raises(SliceError, match="unknown accelerator type 'tpu-v5e'"):
        topology_plan(*args, accel_type="tpu-v5e")


def test_an_unnamed_plan_is_hosts_by_gpus():
    """No type named: any shape goes, the layout says hosts x GPUs, and no
    ACCELERATOR_TYPE is exported."""
    plan = topology_plan(_targets(3), ["a", "b", "c"], ["1.1.1.1", "2.2.2.2", "3.3.3.3"], 5)
    assert plan["slice"]["layout"] == "3x5" and plan["slice"]["total_gpus"] == 15
    assert plan["workers"][2]["env"] == {"NODE_RANK": "2", "MASTER_ADDR": "1.1.1.1",
                                         "NNODES": "3", "NPROC_PER_NODE": "5",
                                         "WORLD_SIZE": "15"}


def test_the_default_gpus_per_host_is_an_h100_hosts(stacks):
    """/addslice without gpusPerHost mounts 8 a host (the reference's default
    of 4 is a v5e host's): on 4-GPU hosts that is InsufficientGPU, 503."""
    stack = stacks["port"]
    _pods(stack, "default8", 1)
    status, text, _ = stack.post("/addslice", {"pods": [{"pod": "default8-0"}]})
    assert (status, text) == (503, "slice mount failed (default8-0: InsufficientGPU)")
    assert stack.free() == len(NODES) * PER_NODE
