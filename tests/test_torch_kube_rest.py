"""The port's ``RestKubeClient`` against the reference's, on one stand-in API
server (``gpumounter_tpu_torch/testing/kube_api.py``, HTTPS with a self-signed certificate).

The two clients make the same calls, each against its own fresh server over
a ``FakeKubeClient``: they must send the same method, path, query and body,
and return the same dicts, watch events, leases and a LIST's resourceVersion
included; a kubeconfig and the in-cluster environment must give the same
host, port and token; a server that is down or stalls must fail both alike,
as errors ``classify_exception`` types as the reference's does and ApiHealth
counts. Every comparison is exact.
"""

from __future__ import annotations

import base64
import functools
import os
import threading

import pytest
import yaml
from gpumounter_tpu_torch.testing.kube_api import FakeApiServer, selfsigned

from gpumounter_tpu.k8s import client as ref_client
from gpumounter_tpu.k8s import errors as ref_errors
from gpumounter_tpu.k8s import health as ref_health
from gpumounter_tpu_torch.k8s import client as port_client
from gpumounter_tpu_torch.k8s import errors as port_errors
from gpumounter_tpu_torch.k8s import health as port_health
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient

CLIENTS = {"port": (port_client, port_errors), "reference": (ref_client, ref_errors)}


@pytest.fixture(scope="module")
def tls(tmp_path_factory):
    pair = selfsigned(str(tmp_path_factory.mktemp("tls")))
    if pair is None:
        pytest.skip("openssl is needed for the stand-in API server's certificate")
    return pair


@pytest.fixture()
def servers(tls):
    """A fresh stand-in API server for each client."""
    made = {name: FakeApiServer(FakeKubeClient(), *tls).start() for name in CLIENTS}
    yield made
    for server in made.values():
        server.stop()


def _client(name, server, tls):
    mod, _ = CLIENTS[name]
    return mod.RestKubeClient("127.0.0.1", server.port, server.token, ca_file=tls[0])


def _pod(name, ns="default", labels=None, node=""):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns, "uid": f"uid-{name}",
                         "labels": labels or {}},
            "spec": {"nodeName": node, "containers": [{"name": "main", "image": "app"}]}}


def _pod_calls(kube, errors) -> list:
    out = [kube.create_pod("default", _pod("a", labels={"app": "x", "tier": "1"}, node="n1")),
           kube.create_pod("default", _pod("b", labels={"app": "y"}, node="n2")),
           kube.create_pod("kube-system", _pod("w", "kube-system", {"app": "x"}, "n1")),
           kube.get_pod("default", "a"),
           kube.list_pods("default"),
           kube.list_pods("default", label_selector="app=x"),
           kube.list_pods("default", label_selector="app!=x,tier"),
           kube.list_pods("default", field_selector="spec.nodeName=n2"),
           kube.list_pods(None, label_selector="app=x"),
           kube.patch_pod("default", "a", {"metadata": {"labels": {"tier": None, "new": "1"}},
                                           "status": {"phase": "Running"}})]
    kube.delete_pod("default", "b", grace_period_seconds=0)
    kube.delete_pod("default", "never-there")  # a no-op, as in the fake
    for call in (lambda: kube.get_pod("default", "b"),
                 lambda: kube.create_pod("default", _pod("a"))):
        with pytest.raises(errors.ApiError) as exc:
            call()
        out.append((type(exc.value).__name__, exc.value.status))
    out.append(kube.list_pods("default"))
    return out


def test_pod_calls_send_and_return_the_same(servers, tls):
    got = {name: _pod_calls(_client(name, servers[name], tls), CLIENTS[name][1])
           for name in CLIENTS}
    assert got["port"] == got["reference"]
    assert servers["port"].requests == servers["reference"].requests
    assert len(servers["port"].requests) == 15
    # one kept-alive connection serves every call of the thread
    assert servers["port"].connections == servers["reference"].connections == 1


def _watch_events(kube, server) -> list:
    watch = kube.watch_pods("default", label_selector="app=x", timeout_s=30)
    server.kube.create_pod("default", _pod("a", labels={"app": "x"}))
    server.kube.create_pod("default", _pod("other", labels={"app": "y"}))
    server.kube.patch_pod("default", "a", {"status": {"podIP": "10.0.0.1"}})
    server.kube.delete_pod("default", "a")
    events = [next(watch) for _ in range(3)]
    watch.close()
    return events


def test_watch_events_are_the_same(servers, tls):
    got = {name: _watch_events(_client(name, servers[name], tls), servers[name])
           for name in CLIENTS}
    assert got["port"] == got["reference"]
    assert [etype for etype, _ in got["port"]] == ["ADDED", "MODIFIED", "DELETED"]
    assert got["port"][1][1]["status"]["podIP"] == "10.0.0.1"
    assert servers["port"].requests == servers["reference"].requests
    method, path, query, body = servers["port"].requests[-1]
    assert (method, path, body) == ("GET", "/api/v1/namespaces/default/pods", None)
    assert query == {"watch": "true", "timeoutSeconds": "30", "labelSelector": "app=x"}


def test_an_expired_watch_is_gone(servers, tls):
    for name, (_, errors) in CLIENTS.items():
        watch = _client(name, servers[name], tls).watch_pods(
            "default", timeout_s=5, resource_version="expired")
        with pytest.raises(errors.GoneError):
            next(watch)


def test_wait_for_pod_over_rest(servers, tls):
    """The composed wait: the watch opens before the read, so a change that
    lands after the call starts is seen."""
    for name in CLIENTS:
        kube, server = _client(name, servers[name], tls), servers[name]
        server.kube.create_pod("default", _pod("p"))
        threading.Timer(0.05, lambda s=server: s.kube.set_pod_status(
            "default", "p", phase="Running")).start()
        got = kube.wait_for_pod("default", "p",
                                lambda pj: pj is not None and pj["status"]["phase"] == "Running",
                                timeout_s=10)
        assert got["metadata"]["name"] == "p" and got["status"]["phase"] == "Running"


def test_api_errors_are_typed_alike():
    for status, name in [(404, "NotFoundError"), (409, "ConflictError"), (410, "GoneError"),
                         (500, "ServerError"), (503, "ServerError"), (400, "ApiError")]:
        seen = []
        for errors in (port_errors, ref_errors):
            with pytest.raises(errors.ApiError) as exc:
                errors.raise_for(status, "body")
            seen.append((type(exc.value).__name__, exc.value.status, str(exc.value)))
        assert seen[0] == seen[1]
        assert seen[0][0] == name


def _kubeconfig(path, server, user, ca_file=None, ca_data=None, extra=None):
    cluster = {"server": server, **(extra or {})}
    if ca_file:
        cluster["certificate-authority"] = ca_file
    if ca_data:
        cluster["certificate-authority-data"] = ca_data
    doc = {"apiVersion": "v1", "kind": "Config", "current-context": "ctx",
           "clusters": [{"name": "c", "cluster": cluster}],
           "users": [{"name": "u", "user": user}],
           "contexts": [{"name": "ctx", "context": {"cluster": "c", "user": "u"}}]}
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def test_a_kubeconfig_gives_the_same_client(servers, tls, tmp_path):
    server = servers["port"]
    server.kube.create_pod("default", _pod("a"))
    ca_data = base64.b64encode(open(tls[0], "rb").read()).decode()
    token_file = tmp_path / "token"
    token_file.write_text(server.token + "\n")
    for i, (user, ca) in enumerate([({"token": server.token}, {"ca_file": tls[0]}),
                                    ({"tokenFile": str(token_file)}, {"ca_data": ca_data})]):
        path = _kubeconfig(tmp_path / f"kc{i}", f"https://127.0.0.1:{server.port}", user, **ca)
        made = [mod.kubeconfig_client(path) for mod, _ in CLIENTS.values()]
        assert [(c.host, c.port, c.token) for c in made] == \
            [("127.0.0.1", server.port, server.token)] * 2
        assert [c.get_pod("default", "a")["metadata"]["name"] for c in made] == ["a", "a"]


def test_an_mtls_only_kubeconfig_sends_no_bearer_header(tls, tmp_path):
    """A user with a client certificate and no token: the port's client
    sends no Authorization header and its certificate is enough. The
    reference sends `Bearer ` with nothing after it, which a server that
    refuses an empty credential answers 401."""
    cert, key = selfsigned(str(tmp_path), client=True)
    server = FakeApiServer(FakeKubeClient(), *tls, client_ca=cert).start()
    try:
        server.kube.create_pod("default", _pod("a"))
        user = {"client-certificate-data": base64.b64encode(open(cert, "rb").read()).decode(),
                "client-key-data": base64.b64encode(open(key, "rb").read()).decode()}
        path = _kubeconfig(tmp_path / "kc", f"https://127.0.0.1:{server.port}", user,
                           ca_file=tls[0])
        client = port_client.kubeconfig_client(path)
        assert client.token == ""
        assert client.get_pod("default", "a")["metadata"]["name"] == "a"
        assert server.authorization == [None]
        with pytest.raises(ref_errors.ApiError) as exc:
            ref_client.kubeconfig_client(path).get_pod("default", "a")
        assert exc.value.status == 401
        assert server.authorization == [None, "Bearer "]
    finally:
        server.stop()


@pytest.mark.parametrize("server, user", [
    ("http://127.0.0.1:1", {"token": "t"}),
    ("https://127.0.0.1:1", {"exec": {"command": "helper"}}),
    ("https://127.0.0.1:1", {}),
    ("https://127.0.0.1:1", {"client-certificate": "/c.crt"}),
], ids=["http", "exec-plugin", "no-credential", "cert-without-key"])
def test_a_kubeconfig_is_refused_alike(tmp_path, server, user):
    path = _kubeconfig(tmp_path / "kc", server, user, extra={"insecure-skip-tls-verify": True})
    seen = []
    for mod, _ in CLIENTS.values():
        with pytest.raises(ValueError) as exc:
            mod.kubeconfig_client(path)
        seen.append(str(exc.value).split(";")[0])
    assert seen[0].split(" ")[:4] == seen[1].split(" ")[:4]


def test_the_in_cluster_environment_gives_the_same_client(tmp_path, monkeypatch, tls):
    token = tmp_path / "token"
    token.write_text("sa-token\n")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    monkeypatch.setenv("TPUMOUNTER_TOKEN_FILE", str(token))
    monkeypatch.setenv("TPUMOUNTER_CA_FILE", tls[0])
    made = [mod.in_cluster_client() for mod, _ in CLIENTS.values()]
    made += [mod.default_client() for mod, _ in CLIENTS.values()]
    assert {(c.host, c.port, c.token) for c in made} == {("10.96.0.1", 6443, "sa-token")}
    monkeypatch.setenv("TPUMOUNTER_CA_FILE", str(tmp_path / "absent.crt"))
    for mod, _ in CLIENTS.values():
        with pytest.raises(FileNotFoundError, match="TPUMOUNTER_INSECURE_SKIP_TLS_VERIFY"):
            mod.in_cluster_client()
    monkeypatch.setenv("TPUMOUNTER_INSECURE_SKIP_TLS_VERIFY", "1")
    assert [mod.in_cluster_client().ctx.check_hostname for mod, _ in CLIENTS.values()] == \
        [False, False]
    monkeypatch.delenv("TPUMOUNTER_TOKEN_FILE")
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "none"))
    for mod, _ in CLIENTS.values():
        with pytest.raises(RuntimeError, match="automountServiceAccountToken"):
            mod.default_client()
    assert not os.path.exists(tmp_path / "none")


def _events_and_write_faults(kube, errors, fp) -> list:
    """An Event posted, then writes under injected API statuses: each
    answer, or the typed error and its status."""
    manifest = {"apiVersion": "v1", "kind": "Event", "metadata": {"name": "p.tpumounter.1",
                                                                   "namespace": "default"},
                "involvedObject": {"kind": "Pod", "name": "p", "namespace": "default"},
                "reason": "GPUMounted", "message": "m", "type": "Normal", "count": 1}
    out = [kube.create_event("default", manifest)]
    kube.create_pod("default", _pod("a"))
    for schedule, call in (({"k8s.create_pod.status": "1*return(409)"},
                            lambda: kube.create_pod("default", _pod("c"))),
                           ({"k8s.patch_pod.status": "1*return(503)"},
                            lambda: kube.patch_pod("default", "a", {"metadata": {}})),
                           ({"k8s.delete_pod.status": "1*return(404)"},
                            lambda: kube.delete_pod("default", "a")),
                           ({"k8s.delete_pod": "1*error(injected)"},
                            lambda: kube.delete_pod("default", "a"))):
        with fp.armed(schedule):
            try:
                out.append(call())
            except errors.ApiError as exc:
                out.append((type(exc).__name__, exc.status))
            except fp.FailpointError as exc:
                out.append(str(exc))
    out.append([p["metadata"]["name"] for p in kube.list_pods("default")])
    return out


def test_events_and_injected_write_statuses_are_the_same(servers, tls):
    """create_event posts to /api/v1/namespaces/<ns>/events; a write under
    k8s.<op>.status raises the typed error before any request (a 404 on a
    delete is the no-op of a missing pod), and k8s.<op> fails the write."""
    from gpumounter_tpu.faults import failpoints as ref_failpoints
    from gpumounter_tpu_torch.faults import failpoints
    fps = {"port": failpoints, "reference": ref_failpoints}
    got = {name: _events_and_write_faults(_client(name, servers[name], tls), CLIENTS[name][1],
                                          fps[name]) for name in CLIENTS}
    assert got["port"] == got["reference"]
    assert got["port"][1:4] == [("ConflictError", 409), ("ServerError", 503), None]
    assert servers["port"].requests == servers["reference"].requests
    assert [(m, p) for m, p, _, _ in servers["port"].requests][:2] == [
        ("POST", "/api/v1/namespaces/default/events"), ("POST", "/api/v1/namespaces/default/pods")]
    assert servers["port"].kube.events_posted == servers["reference"].kube.events_posted


# --- leases, a LIST's resourceVersion, and transport failures ---

def test_leases_and_a_listed_version_send_and_return_the_same(servers, tls):
    got = {}
    for name, server in servers.items():
        kube, errors = _client(name, server, tls), CLIENTS[name][1]
        out = [kube.list_pods_with_rv("default")]
        kube.create_pod("default", _pod("a"))
        out.append(kube.list_pods_with_rv("default"))
        first = kube.create_lease("kube-system", {"metadata": {"name": "l"},
                                                  "spec": {"holderIdentity": "a"}})
        out += [first, kube.get_lease("kube-system", "l")]
        out.append(kube.update_lease("kube-system", "l",
                                     dict(first, spec={"holderIdentity": "b"})))
        for call in (lambda: kube.update_lease("kube-system", "l", first),  # a stale version
                     lambda: kube.create_lease("kube-system", {"metadata": {"name": "l"}}),
                     lambda: kube.get_lease("kube-system", "ghost")):
            with pytest.raises(errors.ApiError) as exc:
                call()
            out.append((type(exc.value).__name__, exc.value.status))
        got[name] = (out, server.requests)
    assert got["port"] == got["reference"]
    out = got["port"][0]
    assert out[0] == ([], "0") and out[1][1] == "1"
    assert out[4]["metadata"]["resourceVersion"] == "2"
    assert out[5:] == [("ConflictError", 409), ("ConflictError", 409), ("NotFoundError", 404)]


@pytest.mark.parametrize("failure", ["stopped", "stalled"])
def test_a_transport_failure_is_classified_and_counted_alike(servers, tls, failure):
    """A server that is down (a refused connection) and one that does not
    answer within the client's deadline (a socket timeout): both clients
    raise the same exception, ``classify_exception`` makes it PartitionError
    and ApiTimeoutError, and three of them make ApiHealth degraded."""
    healths = {"port": port_health, "reference": ref_health}
    got = {}
    for name, server in servers.items():
        kube, errors = _client(name, server, tls), CLIENTS[name][1]
        kube._connect = functools.partial(kube._connect, timeout=0.3)
        if failure == "stopped":
            server.stop()
        else:
            server.stall_s = 1.0
        machine = healths[name].ApiHealth(cfg=None)
        tracked = healths[name].HealthTrackingKubeClient(kube, machine)
        raised = []
        for _ in range(3):
            with pytest.raises(Exception) as exc:
                tracked.get_pod("default", "a")
            typed = errors.classify_exception(exc.value)
            raised.append((type(exc.value).__name__, type(typed).__name__, typed.status,
                           errors.is_outage(exc.value)))
        got[name] = raised, machine.state(), machine.payload()["planes"]["read"]["state"]
        if failure == "stopped":
            server.start = lambda: server  # stopped for good: the fixture's stop is a no-op
            server.stop = lambda: None
        else:
            server.stall_s = 0.0
    assert got["port"] == got["reference"]
    raised, state, _ = got["port"]
    want = ("PartitionError", 503) if failure == "stopped" else ("ApiTimeoutError", 504)
    assert {r[1:3] for r in raised} == {want} and all(r[3] for r in raised)
    assert state == "degraded"
