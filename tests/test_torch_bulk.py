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
"""

from __future__ import annotations

import threading
import time

import pytest
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
