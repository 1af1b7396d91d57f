"""The tenant plane's worker half (``gpumounter_tpu_torch/obs/tenants.py``)
and the worker's ops port (``gpumounter_tpu_torch/worker/main.py``),
against the reference's.

The store keeps a tenant's latest snapshot up to its cap and folds the rest
into ``_overflow``, as the reference's does on the same ingests; both
parsers take and refuse the same bodies. The port's ``TenantTelemetry``
(``torchside/telemetry.py``) posts to the port's ops port with the mutate
token, and the snapshot lands in the worker's telemetry; the read token is
refused there. Then the ops port of each package answers the same table of
requests (each route, each scope) with the same status codes.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.obs import tenants as ref_tenants
from gpumounter_tpu.worker import main as ref_main
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.obs import tenants
from gpumounter_tpu_torch.torchside.telemetry import TenantTelemetry
from gpumounter_tpu_torch.worker import main

MUTATE, READ = "tenant-test-mutate", "tenant-test-read"
SCHEMA = "tpumounter-tenant/1"


@pytest.mark.parametrize("cap", [1, 16, 256])
def test_the_store_caps_tenants_and_folds_the_rest_as_the_references(cap):
    rng = np.random.default_rng(cap)
    stores = {"reference": ref_tenants.TenantStore(max_tenants=cap),
              "port": tenants.TenantStore(max_tenants=cap)}
    keys = {name: [] for name in stores}
    for i in range(3 * cap + 5):
        snap = {"schema": SCHEMA, "tenant": f"churn/p-{int(rng.integers(2 * cap + 3))}",
                "at": float(i), "tokens_total": float(i)}
        for name, store in stores.items():
            keys[name].append(store.ingest(dict(snap)))
    assert keys["port"] == keys["reference"]
    exported = {name: {k: {f: v for f, v in snap.items() if f != "received_at"}
                       for k, snap in store.export().items()}
                for name, store in stores.items()}
    assert exported["port"] == exported["reference"]
    assert len(exported["port"]) == cap + 1
    assert exported["port"][tenants.OVERFLOW_TENANT]["folded_tenants"] > 0
    assert stores["port"].tenant_count() == cap + 1


BODIES = {
    "a snapshot": json.dumps({"schema": SCHEMA, "tenant": "a/b", "steps": {"count": 3}}).encode(),
    "the same as text": json.dumps({"schema": SCHEMA, "tenant": "a/b"}),
    "empty": b"",
    "not JSON": b"not json",
    "a list": b"[1,2]",
    "another schema": b'{"schema": "wrong", "tenant": "a/b"}',
    "no tenant": json.dumps({"schema": SCHEMA}).encode(),
    "an empty tenant": json.dumps({"schema": SCHEMA, "tenant": ""}).encode(),
    "a tenant not a string": json.dumps({"schema": SCHEMA, "tenant": 7}).encode(),
    "not UTF-8": b"\xff\xfe{",
    "None": None,
}


@pytest.mark.parametrize("case", list(BODIES))
def test_both_parsers_take_and_refuse_the_same_bodies(case):
    got = tenants.parse_tenant_snapshot(BODIES[case])
    assert got == ref_tenants.parse_tenant_snapshot(BODIES[case])
    assert (got is not None) == (case in ("a snapshot", "the same as text"))


def _request(port: int, method: str, path: str, token: str | None = None,
             body: bytes | None = None, accept: str = "") -> tuple[int, str]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, ""


@pytest.fixture
def ops():
    """The ops port of each package, with a mutate and a read token."""
    servers = {
        "reference": ref_main.serve_ops(0, RefConfig().replace(
            auth_mode="token", auth_token=MUTATE, auth_read_token=READ)),
        "port": main.serve_ops(0, Config(auth_mode="token", auth_token=MUTATE,
                                         auth_read_token=READ), host="127.0.0.1"),
    }
    yield {name: httpd.server_address[1] for name, httpd in servers.items()}
    for httpd in servers.values():
        httpd.shutdown()
        httpd.server_close()
    ref_tenants.TENANTS.reset()


def test_the_tenant_sdk_posts_to_the_ops_port_with_the_mutate_token_only(ops):
    port = ops["port"]
    url = f"http://127.0.0.1:{port}"
    tel = TenantTelemetry("team-a/trainer", pod="trainer", token=MUTATE)
    for _ in range(3):
        with tel.step(tokens=128.0, queue_depth=2):
            pass
    assert tel.publish(url)
    stored = tenants.TENANTS.export()["team-a/trainer"]
    assert stored["steps"]["count"] == 3 and stored["queue_depth"] == 2
    status, body = _request(port, "GET", "/telemetry", READ)
    assert status == 200 and json.loads(body)["tenants"]["team-a/trainer"]["steps"]["count"] == 3
    forged = TenantTelemetry("team-b/forged", token=READ)
    assert not forged.publish(url)
    assert not TenantTelemetry("team-b/forged").publish(url)
    assert "team-b/forged" not in tenants.TENANTS.export()
    rejected = tenants.TENANT_SNAPSHOTS_REJECTED.total()
    assert _request(port, "POST", "/tenant-telemetry", MUTATE, b"{broken")[0] == 400
    assert tenants.TENANT_SNAPSHOTS_REJECTED.total() == rejected + 1


TABLE = [
    ("GET", "/healthz", None), ("GET", "/healthz", READ),
    ("GET", "/metrics", None), ("GET", "/metrics", READ), ("GET", "/metrics", MUTATE),
    ("GET", "/metrics", "wrong"),
    ("GET", "/telemetry", None), ("GET", "/telemetry", READ), ("GET", "/telemetry", MUTATE),
    ("GET", "/audit", None), ("GET", "/audit", READ), ("GET", "/audit?limit=x", READ),
    ("GET", "/audit?op=worker.&limit=3", MUTATE),
    ("GET", "/timeline", None), ("GET", "/timeline", READ),
    ("GET", "/timeline?from=x", READ),
    ("GET", "/apihealth", None), ("GET", "/apihealth", READ),
    ("GET", "/trace/" + "0" * 32, None), ("GET", "/trace/" + "0" * 32, READ),
    ("GET", "/nowhere", READ), ("GET", "/nowhere", None),
    ("POST", "/tenant-telemetry", None), ("POST", "/tenant-telemetry", READ),
    ("POST", "/tenant-telemetry", MUTATE), ("POST", "/elsewhere", MUTATE),
]


def test_both_ops_ports_answer_the_same_table(ops):
    body = json.dumps({"schema": SCHEMA, "tenant": "table/probe"}).encode()
    got = {name: [_request(port, method, path, token, body if method == "POST" else None)[0]
                  for method, path, token in TABLE]
           for name, port in ops.items()}
    assert got["port"] == got["reference"]
    codes = dict(zip(TABLE, got["port"]))
    assert codes[("GET", "/healthz", None)] == 200
    assert codes[("GET", "/metrics", None)] == 401 and codes[("GET", "/metrics", READ)] == 200
    assert codes[("POST", "/tenant-telemetry", READ)] == 401
    assert codes[("POST", "/tenant-telemetry", MUTATE)] == 200


def test_the_ops_metrics_negotiate_openmetrics_with_exemplars(ops):
    from gpumounter_tpu_torch.utils.metrics import MOUNT_LATENCY
    MOUNT_LATENCY.observe(0.02, trace_id="cd" * 16)
    status, classic = _request(ops["port"], "GET", "/metrics", READ)
    assert status == 200 and 'trace_id="' not in classic
    status, om = _request(ops["port"], "GET", "/metrics", READ,
                          accept="application/openmetrics-text")
    assert status == 200 and f'trace_id="{"cd" * 16}"' in om
