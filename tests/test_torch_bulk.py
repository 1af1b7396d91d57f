"""The batch mount (POST /batch/addgpu) on the reference's stack and on the
port's.

The stacks are ``tests/torch_slice_stacks.py``'s: 4 fake nodes of 4, a real
gRPC worker a node, the master over real HTTP. The cases of
``tests/test_bulk_mount.py`` that need no shards (mixed results, the body's
validation, the target cap) run on both and must answer alike, the reference's
TPU words read as GPU. Then what a batch without shards still decides: a
target on a node without a worker (NoWorker), on a node whose breaker is open
(Degraded, with retryAfterS), a pod that is not scheduled, an API error, the
results in request order while node groups finish out of order, and at most
``bulk_node_fanout`` node groups in flight at once.

Then the shard cases of ``tests/test_bulk_mount.py``, on the reference's
``ShardedStack`` and on the port's ``entry._MasterStack`` of two sharded
replicas over two fake nodes (node-a, node-b; the ring gives each package's
replicas the same nodes): the cross-shard proxy, the owner joining the
forwarder's trace, the 307 of a single-target add, no second hop for a
forwarded batch, Unowned and 503 for a shard without an owner, the
admission gate queueing, and the /shards table. The reference's assembled
view of a proxied trace (``obs/assembly.py``) comes with the fleet planes.
"""

from __future__ import annotations

import threading
import time

import pytest
from conftest import AUTH_HEADER, TEST_AUTH_TOKEN
from torch_slice_stacks import NODES, PER_NODE, build_stacks

from gpumounter_tpu_torch.utils.fanout import reset_core


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    reset_core()
    made = build_stacks(str(tmp_path_factory.mktemp("bulk")))
    yield made
    for stack in made.values():
        stack.close()
    reset_core()


def _targets(specs):
    """[(pod, n)] as entries both masters read: the reference's "chips",
    the port's "gpus"."""
    return {"targets": [{"namespace": "default", "pod": pod, "chips": n, "gpus": n}
                        for pod, n in specs]}


def _summary(answer) -> list:
    """What both masters must agree on: each result's pod, node, result,
    the count of UUIDs and the error; then the summary."""
    return [[(r["pod"], r.get("node"), r["result"], len(r.get("uuids", ())), r.get("error"))
             for r in answer["results"]], answer["summary"]]


def _clean(stack, pods) -> None:
    for node in NODES:
        with stack.client(node) as client:
            for pod in pods:
                stack.remove(client, pod, [], force=True, remove_all=True)
    assert stack.free() == len(NODES) * PER_NODE


def _path(s) -> str:
    """Each master's batch route."""
    return "/batch/addgpu" if s.slice_mod.__name__.startswith(
        "gpumounter_tpu_torch") else "/batch/addtpu"


def _each(stacks, fn) -> dict:
    return {name: fn(stack) for name, stack in stacks.items()}


def test_mixed_results(stacks):
    def run(s):
        s.add_pod("bulk-a", "host-0")
        s.add_pod("bulk-b", "host-1")
        status, answer, _ = s.post(_path(s), _targets([("bulk-a", 1), ("bulk-b", 2),
                                                       ("ghost", 1)]))
        record = [status, *_summary(answer), s.free_by_node()]
        _clean(s, ["bulk-a", "bulk-b"])
        return record

    records = _each(stacks, run)
    assert records["port"] == records["reference"]
    assert records["port"][1] == [
        ("bulk-a", "host-0", "Success", 1, None), ("bulk-b", "host-1", "Success", 2, None),
        ("ghost", None, "PodNotFound", 0, "no pod default/ghost")]
    assert records["port"][2] == {"total": 3, "success": 2,
                                  "byResult": {"Success": 2, "PodNotFound": 1}}


@pytest.mark.parametrize("payload", [
    {}, {"targets": []}, {"targets": [{"namespace": "default"}]},
    {"targets": [{"pod": "x", "chips": 0, "gpus": 0}]},
    {"targets": [{"pod": "x", "chips": "lots", "gpus": "lots"}]},
    {"targets": [{"pod": "x", "chips": 65, "gpus": 65}]},
    {"targets": "x"}, [1, 2]], ids=["empty", "no-targets", "no-pod", "zero", "not-a-number",
                                    "over-the-cap", "not-a-list", "not-an-object"])
def test_validation(stacks, payload):
    records = _each(stacks, lambda s: s.post(_path(s), payload)[:2])
    assert records["port"] == records["reference"]
    assert records["port"][0] == 400


def test_target_cap(stacks):
    def run(s):
        many = [{"pod": f"p{i}"} for i in range(s.cfg.bulk_max_targets + 1)]
        return s.post(_path(s), {"targets": many})[:2]

    records = _each(stacks, run)
    assert records["port"] == records["reference"] == (
        400, "too many targets: 257 > 256 (BULK_MAX_TARGETS)")


def test_per_target_refusals(stacks):
    """No worker on the pod's node, a pod no node can take (not scheduled),
    an API error reading a pod, and a breaker open on a node (Degraded with
    retryAfterS): each is that target's result, the rest mount."""
    def run(s):
        s.add_pod("ok-0", "host-0")
        s.add_pod("slow-3", "host-3")
        s.kube.create_pod("default", {"metadata": {"name": "lost", "namespace": "default"},
                                      "spec": {"nodeName": "no-such-node",
                                               "containers": [{"name": "m"}]},
                                      "status": {"phase": "Running"}})
        resource = "nvidia.com/gpu" if _path(s).endswith("gpu") else "google.com/tpu"
        s.kube.create_pod("default", {"metadata": {"name": "pending", "namespace": "default"},
                                      "spec": {"containers": [{"name": "m", "resources": {
                                          "limits": {resource: "100"}}}]}})
        assert s.kube.wait_for_pod("default", "pending",
                                   lambda pj: pj is not None and pj.get("status", {}).get(
                                       "phase") == "Pending", timeout_s=5)
        real_get = s.kube.get_pod

        def flaky_get(namespace, name):
            if name == "flaky":
                raise RuntimeError("api blip")
            return real_get(namespace, name)

        s.kube.get_pod = flaky_get
        degraded = s.registry.worker_address("host-3")
        for _ in range(s.cfg.breaker_failure_threshold):
            s.registry.breaker.record_failure(degraded)
        try:
            status, answer, _ = s.post(_path(s), _targets(
                [("lost", 1), ("ok-0", 1), ("pending", 1), ("flaky", 1), ("slow-3", 1)]))
        finally:
            s.kube.get_pod = real_get
            s.registry.breaker.record_success(degraded)
        retry = [r.pop("retryAfterS") for r in answer["results"] if "retryAfterS" in r]
        assert len(retry) == 1 and 0 < retry[0] <= s.cfg.breaker_reset_s
        record = [status, *_summary(answer), s.free_by_node()]
        _clean(s, ["ok-0"])
        for name in ("lost", "pending"):
            s.kube.delete_pod("default", name)
        return record

    records = _each(stacks, run)
    assert records["port"] == records["reference"]
    assert records["port"][1] == [
        ("lost", "no-such-node", "NoWorker", 0, "no tpumounter worker on node no-such-node"),
        ("ok-0", "host-0", "Success", 1, None),
        ("pending", None, "NotScheduled", 0, "pod pending is not scheduled yet"),
        ("flaky", None, "Error", 0, "kubernetes api error 0: RuntimeError: api blip"),
        ("slow-3", "host-3", "Degraded", 0, "worker on host-3 degraded (circuit open)")]


class _Tracked:
    """A worker client that counts the clients open at once, waits at the
    state's barrier once it is open, and waits `delay_s` before each add."""

    def __init__(self, real, state, delay_s: float):
        self._real, self._state, self._delay_s = real, state, delay_s

    def __enter__(self):
        with self._state["lock"]:
            self._state["now"] += 1
            self._state["most"] = max(self._state["most"], self._state["now"])
        self._state["barrier"].wait()
        self._real.__enter__()
        return self

    def __exit__(self, *exc):
        with self._state["lock"]:
            self._state["now"] -= 1
        return self._real.__exit__(*exc)

    def __getattr__(self, name):
        attr = getattr(self._real, name)
        if not name.startswith("add_"):
            return attr

        def delayed(*args, **kwargs):
            time.sleep(self._delay_s)
            return attr(*args, **kwargs)

        return delayed


@pytest.mark.parametrize("fanout", [2, 16])
def test_request_order_and_the_cap_of_node_groups(stacks, fanout):
    """Targets interleaved over the 4 nodes, node groups that finish in the
    reverse order of their first target: the results keep the request's
    order, and at most bulk_node_fanout groups hold a client at once (all 4
    under 16). Each group waits at a barrier of min(fanout, 4) once it holds
    its client, so the peak is reached whatever the threads' timing, and a
    cap below it breaks the barrier (the request then fails)."""
    def run(s):
        specs = [(f"ord-{j}", NODES[(3 - j) % 4]) for j in range(8)]
        for pod, node in specs:
            s.add_pod(pod, node)
        state = {"lock": threading.Lock(), "now": 0, "most": 0,
                 "barrier": threading.Barrier(min(fanout, len(NODES)), timeout=20)}

        def factory(address):
            node_index = int(address.split(":")[0].rsplit(".", 1)[1]) - 1  # 10.0.0.<i + 1>
            return _Tracked(s.factory(address), state, 0.02 * (4 - node_index))

        app = s.make_app(factory=factory, bulk_node_fanout=fanout)
        status, answer, _ = s.post(_path(s), _targets([(pod, 1) for pod, _ in specs]), app=app)
        record = [status, *_summary(answer), s.free_by_node(), state["most"]]
        _clean(s, [pod for pod, _ in specs])
        for pod, _ in specs:
            s.kube.delete_pod("default", pod)
        return record

    records = _each(stacks, run)
    assert records["port"] == records["reference"]
    assert [r[:3] for r in records["port"][1]] == [
        (f"ord-{j}", NODES[(3 - j) % 4], "Success") for j in range(8)]
    assert records["port"][-1] == min(fanout, len(NODES))


class _FirstArrivals:
    """A barrier for the first `n` callers of ``wait``; later ones pass."""

    def __init__(self, n: int):
        self._n, self._seen, self._lock = n, 0, threading.Lock()
        self._barrier = threading.Barrier(n, timeout=20)

    def wait(self) -> None:
        with self._lock:
            self._seen += 1
            first = self._seen <= self._n
        if first:
            self._barrier.wait()


@pytest.mark.parametrize("shard_budget,node_fanout", [(1, 16), (16, 1)])
def test_the_sharded_batch_caps_each_shard_by_the_shard_budget(stacks, shard_budget,
                                                               node_fanout):
    """With the shards active the port caps a batch's node groups in flight
    of each owner shard by fanout_shard_budget, where the reference caps them
    by bulk_node_fanout (ROADMAP §3); without shards both cap all the groups
    by bulk_node_fanout and ignore fanout_shard_budget. One replica holds
    both shards of 2 (its own lease namespace), so every group is local. As
    in the case above, the first groups wait at a barrier of the peak their
    side must reach, and a cap below it breaks the barrier (a shard may hold
    more nodes than another, so the later groups go through alone)."""
    import importlib

    def run(s):
        port = s.slice_mod.__name__.startswith("gpumounter_tpu_torch")
        shard_mod = importlib.import_module(s.app_module.__name__.rsplit(".", 1)[0] + ".shard")
        record = {}
        for sharded in (True, False):
            cfg = s.with_cfg(shard_count=2, shard_preferred="",
                             shard_lease_namespace=f"budget-{shard_budget}-{node_fanout}",
                             fanout_shard_budget=shard_budget, bulk_node_fanout=node_fanout)
            shards = shard_mod.ShardManager(s.kube, cfg=cfg, replica_id="solo")
            if sharded:
                shards.start_without_loop()
                shards.acquire_once()
                assert shards.owned_shards() == {0, 1}
            per_shard = shard_budget if port else node_fanout
            groups = {shards.owner_shard(node) for node in NODES}
            peak = (min(len(NODES), per_shard * len(groups)) if sharded
                    else min(len(NODES), node_fanout))
            specs = [(f"cap-{j}", NODES[(3 - j) % 4]) for j in range(8)]
            for pod, node in specs:
                s.add_pod(pod, node)
            state = {"lock": threading.Lock(), "now": 0, "most": 0,
                     "barrier": _FirstArrivals(peak)}

            def factory(address, state=state):
                node_index = int(address.split(":")[0].rsplit(".", 1)[1]) - 1
                return _Tracked(s.factory(address), state, 0.02 * (4 - node_index))

            app = s.app_module.MasterApp(s.kube, cfg=cfg, worker_client_factory=factory,
                                         registry=s.registry, shards=shards)
            status, answer, _ = s.post(_path(s), _targets([(pod, 1) for pod, _ in specs]),
                                       app=app)
            assert status == 200 and answer["summary"]["success"] == 8, answer
            record["sharded" if sharded else "unsharded"] = (state["most"], peak, len(groups))
            _clean(s, [pod for pod, _ in specs])
            for pod, _ in specs:
                s.kube.delete_pod("default", pod)
        return record

    records = _each(stacks, run)
    assert records["port"]["unsharded"] == records["reference"]["unsharded"]
    assert records["port"]["unsharded"][0] == min(node_fanout, len(NODES))
    for side, per_shard in (("port", shard_budget), ("reference", node_fanout)):
        most, peak, groups = records[side]["sharded"]
        assert most == peak == min(len(NODES), per_shard * groups), (side, records)


# --- the shard cases (tests/test_bulk_mount.py) ---


class _PortSharded:
    """The port's two sharded replicas over two fake nodes of 4, as the
    reference's ShardedStack: lease 30 s, MASTER_HTTP_CONCURRENCY 4."""

    batch, count = "/batch/addgpu", "gpus"
    worker_span = "worker.AddGPU"

    def __init__(self, root: str):
        import dataclasses
        import os

        from gpumounter_tpu_torch import entry
        from gpumounter_tpu_torch.testing.cluster import FakeCluster
        from gpumounter_tpu_torch.obs import trace
        cluster = FakeCluster.with_fake_gpus(os.path.join(root, "port"),
                                             nodes={"node-a": 4, "node-b": 4})
        cluster.cfg = dataclasses.replace(cluster.cfg, auth_mode="token",
                                          auth_token=TEST_AUTH_TOKEN)
        dirs = {}
        for node in cluster.node_names:
            dirs[node] = os.path.join(root, f"port-dev-{node}")
            os.makedirs(dirs[node])
        self.stack = entry._MasterStack(cluster, dirs, replicas=2, shard_cfg={
            "shard_lease_duration_s": 30.0, "master_http_concurrency": 4})
        self.cluster, self.cfg, self.trace = cluster, self.stack.cfg, trace
        self.apps, self.bases = self.stack.apps, self.stack.bases

    def add_pod(self, name, node):
        self.cluster.add_target_pod(name, node=node)

    def add_path(self, pod):
        return f"/addgpu/namespace/default/pod/{pod}/gpu/1/isEntireMount/false"

    def close(self):
        self.stack.__exit__(None, None, None)


class _RefSharded:
    batch, count = "/batch/addtpu", "chips"
    worker_span = "worker.AddTPU"

    def __init__(self, root: str):
        import os

        from test_bulk_mount import ShardedStack

        from gpumounter_tpu.obs import trace
        self.stack = ShardedStack(os.path.join(root, "ref"))
        self.cluster, self.cfg, self.trace = self.stack.cluster, self.stack.cfg, trace
        self.apps, self.bases = self.stack.apps, self.stack.bases

    def add_pod(self, name, node):
        self.cluster.add_target_pod(name, node=node)

    def add_path(self, pod):
        return f"/addtpu/namespace/default/pod/{pod}/tpu/1/isEntireMount/false"

    def close(self):
        self.stack.stop()


def _owner(side, node, owning=True):
    return next(base for app, base in zip(side.apps, side.bases)
                if app.shards.owns_node(node) == owning)


def _post(side, base, payload, headers=None):
    import json
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + side.batch, data=json.dumps(payload).encode(),
                                 method="POST", headers={**AUTH_HEADER,
                                                         "Content-Type": "application/json",
                                                         **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    reset_core()
    root = str(tmp_path_factory.mktemp("sharded"))
    made = {"reference": _RefSharded(root), "port": _PortSharded(root)}
    yield made
    for side in made.values():
        side.close()
    reset_core()


def _each_sharded(sharded, fn):
    got = {name: fn(side) for name, side in sharded.items()}
    assert got["port"] == got["reference"], got
    return got["port"]


def test_the_replicas_own_the_nodes_alike(sharded):
    owners = _each_sharded(sharded, lambda side: [
        [app.shards.owns_node(n) for n in ("node-a", "node-b")] for app in side.apps])
    assert sorted(map(tuple, owners)) in ([(False, True), (True, False)],
                                          [(False, False), (True, True)])


def test_bulk_mixed_results_and_cross_shard_proxy(sharded):
    def run(side):
        side.add_pod("bulk-a", "node-a")
        side.add_pod("bulk-b", "node-b")
        status, out, _ = _post(side, side.bases[0], {"targets": [
            {"namespace": "default", "pod": "bulk-a", side.count: 1},
            {"namespace": "default", "pod": "bulk-b", side.count: 2},
            {"namespace": "default", "pod": "ghost", side.count: 1}]})
        return (status, [(r["pod"], r["result"], len(r.get("uuids", [])))
                         for r in out["results"]], out["summary"])

    assert _each_sharded(sharded, run) == (
        200, [("bulk-a", "Success", 1), ("bulk-b", "Success", 2), ("ghost", "PodNotFound", 0)],
        {"total": 3, "success": 2, "byResult": {"Success": 2, "PodNotFound": 1}})


def test_proxied_bulk_joins_forwarding_replicas_trace(sharded):
    def run(side):
        side.add_pod("bulk-tr", "node-a")
        status, out, headers = _post(side, _owner(side, "node-a", False), {"targets": [
            {"namespace": "default", "pod": "bulk-tr", side.count: 1}]})
        tid = headers["X-Tpumounter-Trace"]
        spans = side.trace.TRACER.ring.spans_for(tid)
        names = [s["name"] for s in spans]
        proxy = next(s for s in spans if s["name"] == "proxy.batch")
        root = next(s for s in spans if s["span_id"] == proxy["parent_id"])
        owner_edges = [s for s in spans if s["name"] == "http.batch_add"
                       and s["parent_id"] == proxy["span_id"]]
        return (status, out["results"][0]["result"], names.count("http.batch_add"),
                side.worker_span in names, (root["name"], root["parent_id"]), len(owner_edges))

    assert _each_sharded(sharded, run) == (200, "Success", 2, True, ("http.batch_add", ""), 1)


def test_single_target_redirects_to_owner(sharded):
    import urllib.error
    import urllib.request

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    def run(side):
        side.add_pod("redir", "node-a")
        path = side.add_path("redir")
        req = urllib.request.Request(_owner(side, "node-a", False) + path, headers=AUTH_HEADER)
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            urllib.request.build_opener(NoRedirect).open(req)
        location = excinfo.value.headers["Location"]
        with urllib.request.urlopen(urllib.request.Request(location, headers=AUTH_HEADER)) \
                as resp:
            followed = resp.status, b"Success" in resp.read()
        return excinfo.value.code, location == _owner(side, "node-a") + path, followed

    assert _each_sharded(sharded, run) == (307, True, (200, True))


def test_forwarded_request_never_rehops(sharded):
    def run(side):
        side.add_pod("fwd", "node-b")
        status, out, _ = _post(side, _owner(side, "node-b", False),
                               {"targets": [{"namespace": "default", "pod": "fwd"}]},
                               headers={"X-Tpumounter-Forwarded": "1"})
        return status, out["results"][0]["result"]

    assert _each_sharded(sharded, run) == (200, "NotOwner")


def test_unowned_shard_answers_per_target_and_503(sharded):
    import urllib.error
    import urllib.request

    def run(side):
        side.add_pod("orphan", "node-a")
        try:
            for app in side.apps:
                app.shards.release_all()
                with app.shards._lock:
                    app.shards._peers.clear()
            status, out, _ = _post(side, side.bases[0],
                                   {"targets": [{"namespace": "default", "pod": "orphan"}]})
            entry = out["results"][0]
            req = urllib.request.Request(side.bases[0] + side.add_path("orphan"),
                                         headers=AUTH_HEADER)
            with pytest.raises(urllib.error.HTTPError) as excinfo:
                urllib.request.urlopen(req)
            return (status, entry["result"], entry.get("retryAfterS"), excinfo.value.code,
                    excinfo.value.headers.get("Retry-After"))
        finally:
            for _ in range(2):
                for app in side.apps:
                    app.shards.acquire_once()

    assert _each_sharded(sharded, run) == (200, "Unowned", 1, 503, "1")


def test_admission_gate_queues_instead_of_failing(sharded):
    def run(side):
        for i in range(3):
            side.add_pod(f"storm-{i}", "node-a")
        statuses, lock = [], threading.Lock()

        def one(i):
            status, _, _ = _post(side, side.bases[0], {"targets": [
                {"namespace": "default", "pod": f"storm-{i % 3}", side.count: 1}]})
            with lock:
                statuses.append(status)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return statuses

    assert _each_sharded(sharded, run) == [200] * 12


def test_the_admission_wait_is_a_span_inside_the_edge(sharded):
    """The gate's wait is ``http.admission``, a child of the traced route's
    edge span, with the route's name and whether it was forwarded."""
    def run(side):
        side.add_pod("gated", "node-b")
        _, _, headers = _post(side, _owner(side, "node-b"), {"targets": [
            {"namespace": "default", "pod": "gated", side.count: 1}]})
        spans = side.trace.TRACER.ring.spans_for(headers["X-Tpumounter-Trace"])
        edge = next(s for s in spans if s["name"] == "http.batch_add")
        gate = [s for s in spans if s["name"] == "http.admission"]
        return (len(gate), gate[0]["parent_id"] == edge["span_id"],
                gate[0]["attrs"]["route"], gate[0]["attrs"]["forwarded"])

    assert _each_sharded(sharded, run) == (1, True, "batch_add", False)


def test_shards_route_serves_table(sharded):
    import json
    import urllib.request

    def run(side):
        req = urllib.request.Request(side.bases[0] + "/shards", headers=AUTH_HEADER)
        with urllib.request.urlopen(req) as resp:
            table = json.loads(resp.read())
        return (table["shardCount"], table["active"], sorted(e["shard"] for e in table["shards"]),
                sorted(e["holder"] for e in table["shards"]))

    # after the unowned case's hand-back the first replica to pass may hold
    # both shards: who holds which is compared across the packages only
    count, active, shards, holders = _each_sharded(sharded, run)
    assert (count, active, shards) == (2, True, [0, 1])
    assert set(holders) <= {"m-0", "m-1"}


def test_every_worker_call_carries_the_owner_shards_epoch(sharded, monkeypatch):
    """The port's replicas stamp the owner shard's epoch on the batch's and
    the single add's worker calls (a redirected one too), and the worker
    keeps it."""
    from gpumounter_tpu_torch.rpc.client import WorkerClient
    side = sharded["port"]
    stack = side.stack
    seen = []
    add = WorkerClient.add_gpu

    def recording(self, *args, epoch: int = 0, **kwargs):
        seen.append(epoch)
        return add(self, *args, epoch=epoch, **kwargs)

    monkeypatch.setattr(WorkerClient, "add_gpu", recording)
    side.add_pod("stamped", "node-b")
    stack.acquire()
    owner = next(app for app in side.apps if app.shards.owns_node("node-b"))
    epoch = owner.shards.node_epoch("node-b")
    status, out, _ = _post(side, side.bases[0], {"targets": [{"namespace": "default",
                                                              "pod": "stamped"}]})
    assert status == 200 and out["results"][0]["result"] == "Success"
    status, _, _ = stack.http("POST", "/removegpu/namespace/default/pod/stamped/force/true",
                              {"uuids": ",".join(out["results"][0]["uuids"])})
    assert status == 200
    status, body, _ = stack.http("GET", side.add_path("stamped"))
    assert status == 200, body
    assert epoch >= 1 and seen and set(seen) == {epoch}
    assert stack.services["node-b"]._node_epoch == epoch
