"""ApiHealth and the typed errors: the port's ``k8s/health.py`` and
``k8s/errors.py`` against the reference's.

The cases of ``tests/test_api_health.py`` that need neither the CLI nor the
worker's ops port, each run on both packages (``tests/torch_store_sides.py``)
with what they return compared: the errors' mapping and classification over
one list of exceptions, the state machine's verdicts, plane states,
transitions, payloads and series over the same outcome sequences on an
injected clock, the plane each tracked method is counted on, and the
master's /healthz and /apihealth bodies (the times masked).
"""

from __future__ import annotations

import http.client
import json
import socket
import ssl

import pytest
from conftest import AUTH_HEADER
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture
from torch_store_sides import SIDES, both, fresh

from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu_torch.master import app as port_app

CFG = dict(api_health_degraded_failures=3, api_health_down_after_s=10.0,
           api_health_recovery_successes=2)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# --- the typed errors ---

@pytest.mark.parametrize("status", [400, 403, 404, 409, 410, 500, 502, 503, 504])
def test_raise_for_maps_a_status_as_the_references(status):
    def case(side):
        with pytest.raises(side.errors.ApiError) as exc:
            side.errors.raise_for(status, "body")
        return type(exc.value).__name__, exc.value.status, \
            isinstance(exc.value, side.errors.ServerError)
    got = both(case)
    assert got["port"] == got["reference"]


#: one list of exceptions, each made from a side's errors module
EXCEPTIONS = {
    "socket.timeout": lambda e: socket.timeout("timed out"),
    "TimeoutError": lambda e: TimeoutError("deadline"),
    "ConnectionResetError": lambda e: ConnectionResetError("peer reset"),
    "ConnectionRefusedError": lambda e: ConnectionRefusedError(111, "refused"),
    "BrokenPipeError": lambda e: BrokenPipeError("gone"),
    "OSError": lambda e: OSError("No route to host"),
    "FileNotFoundError": lambda e: FileNotFoundError("/var/run/secrets/token"),
    "PermissionError": lambda e: PermissionError("denied"),
    "IsADirectoryError": lambda e: IsADirectoryError("/etc/kubernetes"),
    "RemoteDisconnected": lambda e: http.client.RemoteDisconnected("closed"),
    "SSLEOFError": lambda e: ssl.SSLEOFError("eof"),
    "ValueError": lambda e: ValueError("bad json"),
    "ApiError0": lambda e: e.ApiError(0, "unclassified"),
    "ApiError403": lambda e: e.ApiError(403, "forbidden"),
    "NotFoundError": lambda e: e.NotFoundError("gone"),
    "ConflictError": lambda e: e.ConflictError("cas"),
    "GoneError": lambda e: e.GoneError("expired"),
    "ServerError500": lambda e: e.ServerError(500, "boom"),
    "PartitionError": lambda e: e.PartitionError("unreachable"),
    "ApiTimeoutError": lambda e: e.ApiTimeoutError("slow"),
}


@pytest.mark.parametrize("name", list(EXCEPTIONS))
def test_an_exception_is_classified_as_the_references(name):
    def case(side):
        exc = EXCEPTIONS[name](side.errors)
        typed = side.errors.classify_exception(exc)
        return (type(typed).__name__, typed.status, side.errors.is_outage(exc),
                side.errors.is_retriable(exc), typed is exc)
    got = both(case)
    assert got["port"] == got["reference"]
    if name in ("FileNotFoundError", "PermissionError", "IsADirectoryError"):
        assert got["port"][1:4] == (0, False, False)  # local: never an outage
    if name in ("ConnectionResetError", "OSError", "RemoteDisconnected"):
        assert got["port"][:3] == ("PartitionError", 503, True)


def test_a_partition_is_a_5xx_server_error_on_both():
    for side in SIDES.values():
        exc = side.errors.PartitionError("unreachable")
        assert isinstance(exc, side.errors.ServerError) and exc.status == 503


# --- the state machine, over outcome sequences ---

#: (op, plane, what): fail with an error class, ok, a 4xx answer, or the
#: clock moved by `what` seconds
SEQUENCES = {
    "below the threshold": [("fail", "read", "PartitionError")] * 2,
    "degraded, then down": [("fail", "read", "PartitionError")] * 3
    + [("tick", "", 11.0), ("fail", "read", "PartitionError")],
    "a 4xx resets the streak": [("fail", "read", "ServerError")] * 2 + [("4xx", "read", "")]
    + [("fail", "read", "ServerError")] * 2,
    "hysteresis": [("fail", "read", "PartitionError")] * 3
    + [("ok", "read", ""), ("fail", "read", "PartitionError"), ("ok", "read", ""),
       ("ok", "read", "")],
    "planes judged apart": [("ok", "read", ""), ("fail", "write", "PartitionError")] * 5,
    "down and healed": [("fail", "read", "PartitionError")] * 3
    + [("tick", "", 11.0), ("fail", "read", "PartitionError"), ("ok", "read", ""),
       ("ok", "read", "")],
    "write plane down, then healed": [("fail", "write", "PartitionError")] * 2
    + [("tick", "", 11.0), ("fail", "write", "ApiTimeoutError"), ("ok", "write", ""),
       ("ok", "read", ""), ("ok", "write", "")],
    "error classes": [("fail", "read", "ApiTimeoutError"), ("fail", "write", "ServerError"),
                      ("fail", "read", "PartitionError"), ("fail", "read", "ConnectionError")],
}


def _error(side, what):
    if what == "ServerError":
        return side.errors.ServerError(503, "lb hiccup")
    if what == "ConnectionError":
        return ConnectionResetError("reset by peer")
    return getattr(side.errors, what)("gone")


def _run_sequence(side, ops):
    for metric in (side.health.API_HEALTH_STATE, side.health.API_HEALTH_TRANSITIONS,
                   side.health.API_CALL_FAILURES):
        metric.reset()
    clock = Clock()
    machine = side.ApiHealth(cfg=fresh(side, **CFG), endpoint="kube", now=clock)
    transitions = []
    machine.subscribe(lambda old, new: transitions.append((old, new)))
    steps = []
    for op, plane, what in ops:
        if op == "tick":
            clock.t += what
        elif op == "ok":
            machine.record_success(kind=plane)
        elif op == "4xx":
            machine.observe(side.errors.NotFoundError("an answer"), kind=plane)
        else:
            machine.observe(_error(side, what), kind=plane)
        steps.append((machine.state(), machine.plane_state("read"),
                      machine.plane_state("write"), machine.ok(), machine.is_down(),
                      machine.write_plane_ok(), machine.payload()))
    series = [m.snapshot() for m in (side.health.API_HEALTH_STATE,
                                     side.health.API_HEALTH_TRANSITIONS,
                                     side.health.API_CALL_FAILURES)]
    return steps, transitions, series


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_an_outcome_sequence_gives_the_references_verdicts(name):
    got = both(_run_sequence, SEQUENCES[name])
    assert got["port"] == got["reference"]
    steps, transitions, _ = got["port"]
    final = steps[-1]
    expect = {"below the threshold": "healthy", "degraded, then down": "down",
              "a 4xx resets the streak": "healthy", "hysteresis": "healthy",
              "planes judged apart": "degraded", "down and healed": "healthy",
              "write plane down, then healed": "healthy", "error classes": "degraded"}
    assert final[0] == expect[name]
    if name == "down and healed":
        assert transitions == [("healthy", "degraded"), ("degraded", "down"),
                               ("down", "healthy")]
    if name == "planes judged apart":
        assert final[1:3] == ("healthy", "degraded") and not final[5]


def test_the_process_machine_is_shared_and_reset_as_the_references():
    def case(side):
        first = side.health.api_health()
        same = side.health.api_health() is first
        first.record_failure(side.errors.PartitionError(""))
        side.health.reset_all()
        fresh_one = side.health.api_health()
        return same, fresh_one is not first, fresh_one.ok()
    assert both(case) == {"reference": (True, True, True), "port": (True, True, True)}


# --- the tracking client ---

class _Down:
    """A client whose every call raises `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def __getattr__(self, name):
        def call(*args, **kwargs):
            raise self.exc
        return call


METHODS = {
    "get_pod": ("default", "p"), "create_pod": ("default", {"metadata": {"name": "p"}}),
    "delete_pod": ("default", "p"), "list_pods": ("default",),
    "list_pods_with_rv": ("default",), "patch_pod": ("default", "p", {}),
    "watch_pods": ("default",), "create_event": ("default", {}),
    "get_lease": ("ns", "l"), "create_lease": ("ns", {"metadata": {"name": "l"}}),
    "update_lease": ("ns", "l", {}), "get_node": ("n1",), "list_nodes": (),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_a_tracked_method_counts_on_the_references_plane(method):
    def case(side):
        machine = side.ApiHealth(cfg=fresh(side, **CFG), now=Clock())
        kube = side.Tracking(_Down(side.errors.PartitionError("down")), machine)
        with pytest.raises(side.errors.PartitionError):
            getattr(kube, method)(*METHODS[method])
        gap = side.Tracking(_Down(NotImplementedError("no leases")), machine)
        with pytest.raises(NotImplementedError):
            getattr(gap, method)(*METHODS[method])
        return {plane: p["consecutiveFailures"] for plane, p in
                machine.payload()["planes"].items()}
    got = both(case)
    assert got["port"] == got["reference"]
    assert sorted(got["port"].values()) == [0, 1]


def test_the_tracking_client_feeds_both_planes_as_the_references():
    def case(side):
        fake = side.FakeKubeClient()
        machine = side.ApiHealth(cfg=fresh(side, **CFG), now=Clock())
        kube = side.health.wrap_health(fake, machine)
        fake.create_pod("default", {"metadata": {"name": "p"}})
        kube.get_pod("default", "p")
        kube.set_partitioned(True, mode="writes")  # the fake's helper, through the wrapper
        for _ in range(3):
            with pytest.raises(side.errors.PartitionError):
                kube.patch_pod("default", "p", {"metadata": {}})
        kube.get_pod("default", "p")
        for _ in range(5):
            with pytest.raises(side.errors.NotFoundError):
                kube.get_pod("default", "ghost")  # answers: no failure
        return (machine.plane_state("read"), machine.plane_state("write"),
                side.health.wrap_health(kube) is kube)
    got = both(case)
    assert got["port"] == got["reference"] == ("healthy", "degraded", True)


# --- the master's /healthz and /apihealth ---

def _masters():
    """Each package's MasterApp over its own fake, ApiHealth at 2 failures."""
    out = {}
    for name, side in SIDES.items():
        fake = side.FakeKubeClient()
        cfg = fresh(side, api_health_degraded_failures=2, api_health_down_after_s=60.0)
        if name == "reference":
            app = ref_app.MasterApp(fake, cfg=cfg, registry=ref_app.WorkerRegistry(fake, cfg))
        else:
            app = port_app.MasterApp(fake, cfg=cfg)
        out[name] = (app, fake)
    return out


def _masked(body: str) -> dict:
    """The times dropped, and the planes' success streaks: the reference's
    master builds planes the port has not yet (its health plane reads its
    lease at start), which adds a read success of its own."""
    payload = json.loads(body)
    payload["api"].pop("sinceS")
    for plane in payload["api"]["planes"].values():
        plane.pop("consecutiveSuccesses")
    store = payload["store"]
    store["cacheAgesS"] = sorted(store["cacheAgesS"])
    store["writeBehind"].pop("oldestQueuedAgeS")
    return payload


def test_healthz_and_apihealth_answer_as_the_references():
    got = {}
    for name, (app, fake) in _masters().items():
        get = lambda path, authed=True: app.handle(  # noqa: E731
            "GET", path, b"", dict(AUTH_HEADER) if authed else {})
        steps = [get("/healthz", authed=False)[:3], get("/apihealth")[:2],
                 _masked(get("/apihealth")[2]), get("/apihealth", authed=False)[0]]
        app.store.list_worker_pods()  # a cached read: its age shows
        fake.set_partitioned(True)
        for _ in range(2):
            with pytest.raises(Exception):
                app.kube.get_pod("default", "x")
        steps += [get("/healthz", authed=False)[:3], _masked(get("/apihealth")[2])]
        fake.set_partitioned(False)
        app.registry.stop()
        got[name] = steps
    assert got["port"] == got["reference"]
    assert got["port"][0] == (200, "text/plain", "ok\n") and got["port"][3] == 401
    assert got["port"][4] == (200, "text/plain", "ok\napi: degraded\n")
    assert got["port"][5]["api"]["planes"]["read"]["consecutiveFailures"] == 2
    assert got["port"][5]["store"]["cacheAgesS"] == ["worker_pods"]
