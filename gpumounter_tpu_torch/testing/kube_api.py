"""A stand-in Kubernetes API server for the REST clients' tests and for a
worker run as a child process (``testing/worker_process.py``).

``FakeApiServer`` serves the pod calls of the core/v1 REST API over HTTPS
(standard library only) from a ``FakeKubeClient`` of the port: get, list
with label and field selectors (one namespace or all), create, delete,
merge-patch, and watch as a stream of JSON lines; the POST of an Event; and the
coordination.k8s.io/v1 leases (get, create, and the replace that is a CAS on
the resourceVersion); the core/v1 nodes (get and list). A LIST carries the
fake's collection resourceVersion.
Errors are Status objects with the API's codes (404, 409, 415). With
``stall_s`` set, every answer waits that long first (a stalled API server). Every request is recorded as
(method, path, query, body) and every TLS connection counted, so two
clients can be held to the same wire.

A watch whose resourceVersion is "expired" answers one ERROR event of code
410, as an API server does for a version out of its window.

Authentication: the server's bearer token, or, for a server built with
``client_ca``, a client certificate that CA verifies. It requires the
certificate in the handshake, then accepts a request with no Authorization
header; a bearer header that carries no credential (``Bearer `` alone)
is answered 401, as an auth proxy or a webhook authenticator answers it.
The Authorization header of every request is recorded (None when absent).

``selfsigned(dir)`` makes a certificate for 127.0.0.1 with openssl;
``selfsigned(dir, client=True)`` a client certificate, its own CA.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import ssl
import subprocess
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch.k8s.errors import ApiError, ConflictError, NotFoundError

_POD = re.compile(r"^/api/v1/namespaces/(?P<ns>[^/]+)/pods/(?P<name>[^/]+)$")
_PODS = re.compile(r"^/api/v1/(?:namespaces/(?P<ns>[^/]+)/)?pods$")
_EVENTS = re.compile(r"^/api/v1/namespaces/(?P<ns>[^/]+)/events$")
_NODES = re.compile(r"^/api/v1/nodes(?:/(?P<name>[^/]+))?$")
_LEASES = re.compile(r"^/apis/coordination\.k8s\.io/v1/namespaces/(?P<ns>[^/]+)/leases"
                     r"(?:/(?P<name>[^/]+))?$")


def selfsigned(directory: str, client: bool = False) -> tuple[str, str] | None:
    """(cert, key) paths for CN=127.0.0.1 with that IP in its SAN (with
    `client`, CN=tpumounter-client, files client.crt and client.key); None
    without openssl."""
    if not shutil.which("openssl"):
        return None
    stem, subject = ("client", "/CN=tpumounter-client") if client else ("tls", "/CN=127.0.0.1")
    cert, key = os.path.join(directory, f"{stem}.crt"), os.path.join(directory, f"{stem}.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", key, "-out", cert, "-days", "1", "-subj", subject,
                    "-addext", "subjectAltName=IP:127.0.0.1"],
                   check=True, capture_output=True)
    return cert, key


def _status(code: int, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure", "message": message,
            "code": code}


class FakeApiServer:
    def __init__(self, kube, cert: str, key: str, token: str = "api-token",
                 client_ca: str | None = None):
        self.kube = kube
        self.token = token
        self.requests: list[tuple[str, str, dict, object]] = []
        self.authorization: list[str | None] = []
        self.connections = 0
        self.stall_s = 0.0
        self._watches: list = []
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                with server._lock:
                    server.connections += 1

            def _send(self, code: int, doc: dict):
                payload = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _handle(self):
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length)) if length else None
                auth = self.headers.get("Authorization")
                with server._lock:
                    server.requests.append((self.command, url.path, query, body))
                    server.authorization.append(auth)
                by_cert = auth is None and bool(self.connection.getpeercert())
                if auth != f"Bearer {server.token}" and not by_cert:
                    return self._send(401, _status(401, "Unauthorized"))
                if server.stall_s:
                    time.sleep(server.stall_s)
                try:
                    return server._route(self, url.path, query, body)
                except ApiError as exc:
                    return self._send(exc.status, _status(exc.status, exc.message))

            do_GET = do_POST = do_DELETE = do_PATCH = do_PUT = _handle

            def log_message(self, fmt, *args):
                pass

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        if client_ca is not None:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(client_ca)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="fake-api",
                                        daemon=True)

    def start(self) -> "FakeApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # --- the routes ---

    def _route(self, h, path: str, query: dict, body):
        one, many = _POD.match(path), _PODS.match(path)
        if one and h.command == "GET":
            return h._send(200, self.kube.get_pod(one["ns"], one["name"]))
        if one and h.command == "DELETE":
            self.kube.get_pod(one["ns"], one["name"])  # 404 for a missing pod
            self.kube.delete_pod(one["ns"], one["name"],
                                 int(query.get("gracePeriodSeconds", 0)))
            return h._send(200, _status(200, "deleted") | {"status": "Success"})
        if one and h.command == "PATCH":
            if h.headers.get("Content-Type") != "application/merge-patch+json":
                raise ApiError(415, "merge-patch only")
            return h._send(200, self.kube.patch_pod(one["ns"], one["name"], body))
        if many and h.command == "POST":
            try:
                return h._send(201, self.kube.create_pod(many["ns"], body))
            except ConflictError as exc:
                raise ApiError(409, exc.message)
        leases = _LEASES.match(path)
        if leases and leases["name"] and h.command == "GET":
            return h._send(200, self.kube.get_lease(leases["ns"], leases["name"]))
        if leases and leases["name"] and h.command == "PUT":
            return h._send(200, self.kube.update_lease(leases["ns"], leases["name"], body))
        if leases and not leases["name"] and h.command == "POST":
            return h._send(201, self.kube.create_lease(leases["ns"], body))
        nodes = _NODES.match(path)
        if nodes and nodes["name"] and h.command == "GET":
            return h._send(200, self.kube.get_node(nodes["name"]))
        if nodes and h.command == "GET":
            return h._send(200, {"kind": "NodeList", "apiVersion": "v1",
                                 "items": self.kube.list_nodes()})
        events = _EVENTS.match(path)
        if events and h.command == "POST":
            return h._send(201, self.kube.create_event(events["ns"], body))
        if many and h.command == "GET" and query.get("watch") == "true":
            return self._watch(h, many["ns"] or "", query)
        if many and h.command == "GET":
            items, rv = self.kube.list_pods_with_rv(many["ns"], query.get("labelSelector", ""),
                                                    query.get("fieldSelector", ""))
            return h._send(200, {"kind": "PodList", "apiVersion": "v1",
                                 "metadata": {"resourceVersion": rv}, "items": items})
        raise NotFoundError(f"no route {h.command} {path}")

    def _watch(self, h, namespace: str, query: dict):
        # subscribe before the headers go: the client reads the pod after
        # its watch is open and relies on seeing what lands in between
        events = self.kube.watch_pods(namespace, label_selector=query.get("labelSelector", ""),
                                      field_selector=query.get("fieldSelector", ""),
                                      timeout_s=float(query.get("timeoutSeconds", 60)))
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Connection", "close")
        h.end_headers()
        h.close_connection = True
        if query.get("resourceVersion") == "expired":
            events = iter([("ERROR", _status(410, "too old resource version"))])
        try:
            for etype, obj in events:
                h.wfile.write(json.dumps({"type": etype, "object": obj}).encode() + b"\n")
                h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, ssl.SSLError):
            pass  # the client closed its watch
