"""A Kubernetes client: the surface the control plane uses, and the REST
client that speaks it to an API server.

The counterpart of ``gpumounter_tpu/k8s/client.py``. ``KubeClient`` is pods
get / create / delete / list / patch and a watch, with ``wait_for_pod``
composed on top; ``k8s/fake.py`` implements it in memory. ``RestKubeClient``
(:265-711 of the reference) implements it over HTTPS with the standard
library, in place of the original's client-go (``pkg/config/config.go:30-45``):
a bearer token and the cluster's CA, one kept-alive connection a thread,
and the watch as a stream of JSON lines (``_WatchStream``), where the
original busy-polls a pod's phase. ``in_cluster_client`` reads the pod's
service account, ``kubeconfig_client`` a kubeconfig (pyyaml), and
``default_client`` picks the first where a service-account token exists.

``create_event`` posts a core/v1 Event (``k8s/events.py``), a no-op on the
surface's default. ``inject_write_fault`` is the failpoint hook of every
write, shared by both clients (``k8s.<op>`` and ``k8s.<op>.status``).
``list_pods_with_rv`` is a LIST with the collection's resourceVersion (the
watch store's cursor; the surface's default answers an empty one), and
``patch_pod_with_retry`` the bounded retry of an annotation's merge patch.
Leases (coordination.k8s.io/v1, with CAS on resourceVersion) hold the
store's health state and its write probe; nodes (core/v1, get and list)
are the recovery controller's readiness signal (``recovery/``); the
surface's default raises NotImplementedError for both. A transport failure leaves the REST client as
the exception it is (a refused connection, a socket timeout);
``k8s/errors.py``'s ``classify_exception`` types it for ApiHealth.
"""

from __future__ import annotations

import abc
import json
import os
import socket
import ssl
import threading
import time
import urllib.parse
from collections.abc import Iterator
from typing import Any

from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.errors import (
    ApiError,
    GoneError,
    NotFoundError,
    is_retriable,
    raise_for,
)
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("k8s")


def inject_write_fault(op: str, namespace: str, name: str) -> None:
    """The failpoint hook of a write, shared by the REST client and the
    fake, so that a chaos schedule hits either as it would an API server:

      k8s.<op>           delay / error / crash at the write
      k8s.<op>.status    return(409) -> ConflictError, return(5xx) -> ApiError

    ops in use: create_pod, delete_pod, patch_pod, create_lease, update_lease."""
    failpoints.fire(f"k8s.{op}", namespace=namespace, name=name)
    status = failpoints.value(f"k8s.{op}.status", None, namespace=namespace, name=name)
    if status is not None:
        raise_for(int(status), f"failpoint k8s.{op}.status on {namespace}/{name}")


def patch_pod_with_retry(kube: "KubeClient", namespace: str, name: str, patch: dict,
                         attempts: int = 3, base_s: float = 0.1, cap_s: float = 2.0) -> dict:
    """A merge patch tried up to `attempts` times, capped-exponential delays
    from `base_s` between: it carries no resourceVersion, so re-applying it
    after a conflict or a 5xx is safe. A 404 and any other 4xx propagate at
    once, as does the last failure."""
    attempts = max(1, attempts)
    for attempt in range(1, attempts + 1):
        try:
            return kube.patch_pod(namespace, name, patch)
        except NotFoundError:
            raise
        except ApiError as exc:
            if not is_retriable(exc) or attempt >= attempts:
                raise
            delay = min(base_s * 2 ** (attempt - 1), cap_s)
            logger.warning("patch of %s/%s failed (%s, attempt %d/%d); retrying in %.2fs",
                           namespace, name, exc.status, attempt, attempts, delay)
            time.sleep(delay)
    raise AssertionError("unreachable")


class KubeClient(abc.ABC):
    """The surface both the REST client and the fake implement."""

    @abc.abstractmethod
    def get_pod(self, namespace: str, name: str) -> dict: ...

    @abc.abstractmethod
    def create_pod(self, namespace: str, manifest: dict) -> dict: ...

    @abc.abstractmethod
    def delete_pod(self, namespace: str, name: str, grace_period_seconds: int = 0) -> None: ...

    @abc.abstractmethod
    def list_pods(self, namespace: str | None = None, label_selector: str = "",
                  field_selector: str = "") -> list[dict]: ...

    @abc.abstractmethod
    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        """RFC 7386 merge-patch: dicts merge recursively, an explicit None
        deletes the key."""

    @abc.abstractmethod
    def watch_pods(self, namespace: str, *, label_selector: str = "",
                   field_selector: str = "", timeout_s: float = 60.0,
                   resource_version: str = "") -> Iterator[tuple[str, dict]]:
        """Yield (event_type, pod_json) until timeout. Types: ADDED,
        MODIFIED, DELETED; namespace "" watches all. The subscription is
        made at the call, before the first event is read. A
        resource_version resumes after it; one that fell out of the
        server's window raises GoneError."""

    def list_pods_with_rv(self, namespace: str | None = None, label_selector: str = "",
                          field_selector: str = "") -> tuple[list[dict], str]:
        """A LIST and the collection's resourceVersion it was taken at.
        Default: the plain list and an empty cursor (watch from now)."""
        return self.list_pods(namespace, label_selector=label_selector,
                              field_selector=field_selector), ""

    def create_event(self, namespace: str, manifest: dict) -> dict:
        """Post a core/v1 Event. Advisory: the default is a no-op, so a
        client with nowhere to post needs nothing."""
        return {}

    # --- coordination.k8s.io/v1 Leases ---

    def get_lease(self, namespace: str, name: str) -> dict:
        raise NotImplementedError(f"{type(self).__name__} does not support leases")

    def create_lease(self, namespace: str, manifest: dict) -> dict:
        raise NotImplementedError(f"{type(self).__name__} does not support leases")

    def update_lease(self, namespace: str, name: str, manifest: dict) -> dict:
        """A full replace (PUT): the manifest's metadata.resourceVersion must
        be the server's, else ConflictError (the CAS)."""
        raise NotImplementedError(f"{type(self).__name__} does not support leases")

    # --- core/v1 Nodes (the recovery controller's readiness signal) ---

    def get_node(self, name: str) -> dict:
        raise NotImplementedError(f"{type(self).__name__} does not support nodes")

    def list_nodes(self) -> list[dict]:
        raise NotImplementedError(f"{type(self).__name__} does not support nodes")

    def wait_for_pod(self, namespace: str, name: str, predicate,
                     timeout_s: float) -> dict | None:
        """Wait until predicate(pod_json) is truthy; None on timeout.

        Watch-driven, where the original busy-polls the pod's phase with no
        sleep (checkCreateState/checkDeleteState, allocator.go:246-317).
        For a wait on deletion, predicate(None) is True on the DELETED
        event or an absent pod.
        """
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            # Subscribe FIRST, then read the current state: an event that
            # lands between the two is already queued on the open watch.
            watch = self.watch_pods(namespace,
                                    field_selector=f"metadata.name={name}",
                                    timeout_s=min(remaining, 30.0))
            try:
                pod = self.get_pod(namespace, name)
            except NotFoundError:
                pod = None
            if predicate(pod):
                return pod if pod is not None else {"__deleted__": True}
            for etype, obj in watch:
                if etype == "DELETED":
                    if predicate(None):
                        return {"__deleted__": True}
                    continue
                if predicate(obj):
                    return obj
                if time.monotonic() >= deadline:
                    return None


SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class RestKubeClient(KubeClient):
    #: methods that a connection gone stale under a kept-alive socket may
    #: send again once (the server may have seen the first send)
    _STALE_RETRY_METHODS = frozenset({"GET", "PUT", "DELETE", "PATCH"})

    def __init__(self, host: str, port: int, token: str, ca_file: str | None = None,
                 verify: bool = True):
        self.host = host
        self.port = port
        self.token = token
        if verify:
            self.ctx = ssl.create_default_context(cafile=ca_file)
        else:
            self.ctx = ssl.create_default_context()
            self.ctx.check_hostname = False
            self.ctx.verify_mode = ssl.CERT_NONE
        # one kept-alive connection a calling thread (http.client's are not
        # thread-safe, and a lock would serialize every call on one socket)
        self._conn_local = threading.local()

    # --- the request ---

    def _connect(self, timeout: float = 30.0):
        import http.client
        return http.client.HTTPSConnection(self.host, self.port, context=self.ctx,
                                           timeout=timeout)

    def _headers(self, body, content_type: str) -> dict:
        # A client that authenticates by its certificate alone has no token:
        # it sends no Authorization header, since a bearer header with no
        # credential is refused (401) by auth proxies and webhook
        # authenticators.
        headers = {"Accept": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if body is not None:
            headers["Content-Type"] = content_type
        return headers

    @staticmethod
    def _stale_exceptions() -> tuple:
        import http.client
        return (http.client.NotConnected, http.client.CannotSendRequest,
                http.client.BadStatusLine, http.client.ImproperConnectionState,
                ConnectionError, BrokenPipeError, ssl.SSLEOFError)

    def _drop_pooled(self) -> None:
        conn = getattr(self._conn_local, "conn", None)
        self._conn_local.conn = None
        if conn is not None:
            conn.close()

    def _json(self, method: str, path: str, query: dict | None = None,
              body: dict | None = None, content_type: str = "application/json") -> dict:
        """A request on this thread's kept-alive connection. One that went
        stale is rebuilt and the request sent again once: always when the
        send itself failed (the server never saw it), else only for the
        idempotent methods."""
        qs = ("?" + urllib.parse.urlencode(query)) if query else ""
        headers = self._headers(body, content_type)
        payload = json.dumps(body) if body is not None else None
        stale = self._stale_exceptions()
        for attempt in (1, 2):
            conn = getattr(self._conn_local, "conn", None)
            fresh = conn is None
            if fresh:
                conn = self._conn_local.conn = self._connect()
            sent = False
            try:
                conn.request(method, path + qs, body=payload, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read().decode("utf-8", "replace")
            except stale:
                self._drop_pooled()
                if fresh or (sent and method not in self._STALE_RETRY_METHODS) \
                        or attempt == 2:
                    raise
                logger.debug("kept-alive connection stale; reconnecting")
                continue
            except Exception:
                self._drop_pooled()
                raise
            if resp.status >= 400:
                raise_for(resp.status, data)
            return json.loads(data) if data else {}
        raise AssertionError("unreachable")

    # --- pods ---

    def get_pod(self, namespace: str, name: str) -> dict:
        return self._json("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def create_pod(self, namespace: str, manifest: dict) -> dict:
        inject_write_fault("create_pod", namespace, manifest.get("metadata", {}).get("name", ""))
        return self._json("POST", f"/api/v1/namespaces/{namespace}/pods", body=manifest)

    def delete_pod(self, namespace: str, name: str, grace_period_seconds: int = 0) -> None:
        try:
            # inside the try: an injected 404 is a real one's no-op
            inject_write_fault("delete_pod", namespace, name)
            self._json("DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}",
                       query={"gracePeriodSeconds": grace_period_seconds})
        except NotFoundError:
            pass  # delete of a missing pod is a no-op, as in the fake

    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        inject_write_fault("patch_pod", namespace, name)
        return self._json("PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
                          body=patch, content_type="application/merge-patch+json")

    def create_event(self, namespace: str, manifest: dict) -> dict:
        return self._json("POST", f"/api/v1/namespaces/{namespace}/events", body=manifest)

    @staticmethod
    def _pods_path(namespace: str | None) -> str:
        return f"/api/v1/namespaces/{namespace}/pods" if namespace else "/api/v1/pods"

    @staticmethod
    def _selectors(label_selector: str, field_selector: str) -> dict[str, Any]:
        query: dict[str, Any] = {}
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        return query

    def list_pods(self, namespace: str | None = None, label_selector: str = "",
                  field_selector: str = "") -> list[dict]:
        return self.list_pods_with_rv(namespace, label_selector, field_selector)[0]

    def list_pods_with_rv(self, namespace: str | None = None, label_selector: str = "",
                          field_selector: str = "") -> tuple[list[dict], str]:
        doc = self._json("GET", self._pods_path(namespace),
                         query=self._selectors(label_selector, field_selector))
        return doc.get("items", []), str(doc.get("metadata", {}).get("resourceVersion", "")
                                          or "")

    # --- nodes ---

    def get_node(self, name: str) -> dict:
        return self._json("GET", f"/api/v1/nodes/{name}")

    def list_nodes(self) -> list[dict]:
        return self._json("GET", "/api/v1/nodes").get("items", [])

    # --- leases ---

    _LEASES = "/apis/coordination.k8s.io/v1/namespaces"

    def get_lease(self, namespace: str, name: str) -> dict:
        return self._json("GET", f"{self._LEASES}/{namespace}/leases/{name}")

    def create_lease(self, namespace: str, manifest: dict) -> dict:
        inject_write_fault("create_lease", namespace, manifest.get("metadata", {}).get("name", ""))
        return self._json("POST", f"{self._LEASES}/{namespace}/leases", body=manifest)

    def update_lease(self, namespace: str, name: str, manifest: dict) -> dict:
        inject_write_fault("update_lease", namespace, name)
        return self._json("PUT", f"{self._LEASES}/{namespace}/leases/{name}", body=manifest)

    def watch_pods(self, namespace: str, *, label_selector: str = "",
                   field_selector: str = "", timeout_s: float = 60.0,
                   resource_version: str = "") -> Iterator[tuple[str, dict]]:
        query: dict[str, Any] = {"watch": "true", "timeoutSeconds": max(1, int(timeout_s)),
                                 **self._selectors(label_selector, field_selector)}
        if resource_version:
            query["resourceVersion"] = resource_version
        # Opened now, before the first event is read: wait_for_pod opens
        # the watch, then reads the pod, and relies on that order. A
        # connection of its own, never this thread's kept-alive one.
        conn = self._connect(timeout_s + 10.0)
        conn.request("GET", self._pods_path(namespace) + "?" + urllib.parse.urlencode(query),
                     headers=self._headers(None, ""))
        resp = conn.getresponse()
        if resp.status >= 400:
            body = resp.read().decode("utf-8", "replace")
            conn.close()
            raise_for(resp.status, body)
        return _WatchStream(conn, resp)


class _WatchStream:
    """The watch's events, one JSON object a line, read off the connection
    it owns; ``close()`` releases it even when the stream was never read."""

    def __init__(self, conn, resp):
        self._conn = conn
        self._resp = resp
        self._buf = b""
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> tuple[str, dict]:
        if self._done:
            raise StopIteration
        while True:
            while b"\n" in self._buf:
                line, _, self._buf = self._buf.partition(b"\n")
                if not line.strip():
                    continue
                event = json.loads(line)
                etype, obj = event.get("type", ""), event.get("object", {})
                if etype == "ERROR":
                    # an expired resourceVersion comes as an ERROR Status
                    # of code 410 inside the stream: LIST again
                    self.close()
                    code = int(obj.get("code", 0) or 0)
                    if code == 410:
                        raise GoneError(obj.get("message", "watch expired"))
                    raise_for(code or 500, obj.get("message", ""))
                return etype, obj
            try:
                chunk = self._resp.read1(65536)
            except (socket.timeout, TimeoutError):
                chunk = b""
            if not chunk:
                self.close()
                raise StopIteration
            self._buf += chunk

    def close(self) -> None:
        """Safe from another thread: the shutdown wakes a read in progress."""
        if not self._done:
            self._done = True
            if self._conn.sock is not None:
                try:
                    self._conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # already closed by the peer
            self._conn.close()


def kubeconfig_client(path: str | None = None, context: str | None = None) -> RestKubeClient:
    """A client from a kubeconfig (out of the cluster), as the reference's
    (``k8s/client.py:486-620``): path from the argument, $KUBECONFIG or
    ~/.kube/config; the context given or the current one; the cluster's
    https server, certificate-authority[-data] and insecure-skip-tls-verify;
    the user's token or tokenFile, or client-certificate[-data] with
    client-key[-data]. An exec plugin is refused: a privileged daemon runs
    no credential helper."""
    import base64
    import shutil
    import tempfile

    import yaml

    path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}

    def _by_name(section: str, name: str) -> dict:
        for entry in cfg.get(section, []):
            if entry.get("name") == name:
                return entry
        raise ValueError(f"kubeconfig {path}: no {section!r} entry named {name!r}")

    ctx_name = context or cfg.get("current-context")
    if not ctx_name:
        raise ValueError(f"kubeconfig {path}: no current-context and no context argument")
    ctx = _by_name("contexts", ctx_name).get("context", {})
    cluster = _by_name("clusters", ctx.get("cluster", "")).get("cluster", {})
    user = _by_name("users", ctx.get("user", "")).get("user", {})

    server = cluster.get("server", "")
    parsed = urllib.parse.urlsplit(server)
    if parsed.scheme != "https":
        raise ValueError(f"kubeconfig cluster server must be https, got {server!r}")
    ca_file = cluster.get("certificate-authority") or None
    ca_data = None
    if cluster.get("certificate-authority-data"):
        ca_data = base64.b64decode(cluster["certificate-authority-data"]).decode()
        ca_file = None
    verify = not cluster.get("insecure-skip-tls-verify", False)

    if "exec" in user:
        raise ValueError("kubeconfig user uses an exec credential plugin; this client runs "
                         "no external helper: put a token in the token field")
    token = user.get("token", "")
    if not token and user.get("tokenFile"):
        with open(user["tokenFile"], encoding="utf-8") as f:
            token = f.read().strip()
    has_cert = bool(user.get("client-certificate") or user.get("client-certificate-data"))
    has_key = bool(user.get("client-key") or user.get("client-key-data"))
    if not token and not has_cert:
        raise ValueError(f"kubeconfig user {ctx.get('user')!r} has neither a token nor a "
                         f"client certificate")
    if has_cert and not has_key:
        raise ValueError("client-certificate given without client-key")

    client = RestKubeClient(parsed.hostname or "", parsed.port or 443, token,
                            ca_file=ca_file if verify else None, verify=verify)
    if verify and ca_data:
        client.ctx.load_verify_locations(cadata=ca_data)
    if has_cert:
        # load_cert_chain reads files: inline key material touches the disk
        # only in a private directory removed before returning
        tmp = None
        try:
            cert_path, key_path = user.get("client-certificate"), user.get("client-key")
            if user.get("client-certificate-data") or user.get("client-key-data"):
                tmp = tempfile.mkdtemp(prefix="kubeconfig-")
                os.chmod(tmp, 0o700)
                if user.get("client-certificate-data"):
                    cert_path = os.path.join(tmp, "client.crt")
                    with open(cert_path, "wb") as f:
                        f.write(base64.b64decode(user["client-certificate-data"]))
                if user.get("client-key-data"):
                    key_path = os.path.join(tmp, "client.key")
                    with open(key_path, "wb") as f:
                        f.write(base64.b64decode(user["client-key-data"]))
                    os.chmod(key_path, 0o600)
            client.ctx.load_cert_chain(cert_path, key_path)
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
    logger.info("kubeconfig client: context=%s server=%s auth=%s", ctx_name, server,
                "mtls" if has_cert else "token")
    return client


def in_cluster_client() -> RestKubeClient:
    """A client from the pod's service account. KUBERNETES_SERVICE_HOST and
    _PORT, TPUMOUNTER_TOKEN_FILE and TPUMOUNTER_CA_FILE override where it
    looks; without the CA it refuses, unless
    TPUMOUNTER_INSECURE_SKIP_TLS_VERIFY=1."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = int(os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
    token_file = os.environ.get("TPUMOUNTER_TOKEN_FILE", os.path.join(SA_DIR, "token"))
    ca_file = os.environ.get("TPUMOUNTER_CA_FILE", os.path.join(SA_DIR, "ca.crt"))
    with open(token_file) as f:
        token = f.read().strip()
    if os.path.exists(ca_file):
        return RestKubeClient(host, port, token, ca_file=ca_file, verify=True)
    if os.environ.get("TPUMOUNTER_INSECURE_SKIP_TLS_VERIFY") == "1":
        logger.warning("CA file %s missing; TLS verification DISABLED by "
                       "TPUMOUNTER_INSECURE_SKIP_TLS_VERIFY=1", ca_file)
        return RestKubeClient(host, port, token, verify=False)
    raise FileNotFoundError(f"cluster CA not found at {ca_file}; set TPUMOUNTER_CA_FILE or "
                            f"TPUMOUNTER_INSECURE_SKIP_TLS_VERIFY=1")


def default_client() -> RestKubeClient:
    """In the cluster where the service-account token exists (the
    daemons), else from the kubeconfig."""
    token_file = os.environ.get("TPUMOUNTER_TOKEN_FILE", os.path.join(SA_DIR, "token"))
    if os.path.exists(token_file):
        return in_cluster_client()
    try:
        return kubeconfig_client()
    except Exception as exc:
        raise RuntimeError(
            f"no service-account token at {token_file} and no usable kubeconfig "
            f"({type(exc).__name__}: {exc}); in a pod: check automountServiceAccountToken; "
            f"outside: check $KUBECONFIG (pyyaml needed)") from exc
