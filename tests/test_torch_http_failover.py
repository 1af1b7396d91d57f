"""The port's master-replica client (``gpumounter_tpu_torch/rpc/http_failover.py``).

Held to ``tests/test_cli_failover.py``: every scenario runs against the same
scriptable stdlib replicas with the reference's ``MasterEndpoints`` and the
port's, and what each observed (answers, raised errors, the requests each
replica saw) must be equal.
"""

from __future__ import annotations

import json
import time

import pytest
from test_cli_failover import _Replica

from gpumounter_tpu.rpc import http_failover as ref_failover
from gpumounter_tpu_torch.rpc import http_failover as port_failover

SIDES = {"reference": ref_failover, "port": port_failover}


def _pair():
    return _Replica(), _Replica()


def _run(scenario):
    """{side: what the scenario saw}, each side on fresh replicas."""
    seen = {}
    for name, mod in SIDES.items():
        a, b = _pair()
        try:
            seen[name] = scenario(mod, a, b)
        finally:
            a.stop()
            b.stop()
    return seen


def _raised(fn):
    try:
        return ("answer", fn())
    except Exception as exc:  # noqa: BLE001 — the error's kind is the observation
        return ("raised", type(exc).__name__, "ambiguous" in str(exc),
                "redirect loop" in str(exc))


def _comma_list(mod, a, b):
    ep = mod.MasterEndpoints("http://a:1/, http://b:2 ,")
    return ep.bases, _raised(lambda: mod.MasterEndpoints(","))


def _failover_skips_dead(mod, a, b):
    a.answers[("GET", "/healthz")] = (200, "ok", {})
    ep = mod.MasterEndpoints(f"http://127.0.0.1:1,{a.base}")
    first = ep.request("GET", "/healthz")
    ep.request("GET", "/healthz")
    return first, len(a.requests)


def _follows_307(mod, a, b):
    a.answers[("POST", "/batch/addgpu")] = (307, "owner elsewhere",
                                            {"Location": b.base + "/batch/addgpu"})
    b.answers[("POST", "/batch/addgpu")] = (
        lambda body: (200, json.dumps({"echo": json.loads(body)}), {}))
    status, body = mod.MasterEndpoints(a.base).request(
        "POST", "/batch/addgpu", json_body={"targets": [{"pod": "x"}]})
    return status, json.loads(body), b.requests[0][2] == a.requests[0][2]


def _503_once(mod, a, b):
    a.answers[("GET", "/x")] = (503, "unowned", {"Retry-After": "1"})
    b.answers[("GET", "/x")] = (200, "served", {})
    first = mod.MasterEndpoints(f"{a.base},{b.base}").request("GET", "/x")
    b.answers[("GET", "/x")] = (503, "unowned too", {})
    return first, mod.MasterEndpoints(f"{a.base},{b.base}").request("GET", "/x")


def _4xx_is_an_answer(mod, a, b):
    a.answers[("GET", "/missing")] = (404, "no pod", {})
    b.answers[("GET", "/missing")] = (200, "should never be asked", {})
    return mod.MasterEndpoints(f"{a.base},{b.base}").request("GET", "/missing"), b.requests


def _post_on_refused(mod, a, b):
    a.answers[("POST", "/batch/addgpu")] = (200, "ok", {})
    return mod.MasterEndpoints(f"http://127.0.0.1:1,{a.base}").request(
        "POST", "/batch/addgpu", json_body={"targets": []})


def _post_timeout(mod, a, b):
    a.answers[("POST", "/batch/addgpu")] = (lambda body: (time.sleep(1.5), (200, "late", {}))[1])
    b.answers[("POST", "/batch/addgpu")] = (200, "should not run", {})
    ep = mod.MasterEndpoints(f"{a.base},{b.base}", timeout_s=0.4)
    post = _raised(lambda: ep.request("POST", "/batch/addgpu", json_body={"targets": []}))
    posted_elsewhere = len(b.requests)
    a.answers[("GET", "/fleet")] = (lambda body: (time.sleep(1.5), (200, "late", {}))[1])
    b.answers[("GET", "/fleet")] = (200, "served", {})
    return post, posted_elsewhere, ep.request("GET", "/fleet")


def _all_dead(mod, a, b):
    ep = mod.MasterEndpoints("http://127.0.0.1:1,http://127.0.0.1:2", timeout_s=2.0)
    return _raised(lambda: ep.request("GET", "/healthz"))


def _redirect_loop(mod, a, b):
    a.answers[("GET", "/loop")] = (307, "again", {"Location": a.base + "/loop"})
    ep = mod.MasterEndpoints(a.base, max_redirects=3)
    return _raised(lambda: ep.request("GET", "/loop")), len(a.requests)


def _auth_survives_redirect(mod, a, b):
    a.answers[("GET", "/shards")] = (307, "", {"Location": b.base + "/shards"})
    b.answers[("GET", "/shards")] = (200, "ok", {})
    answer = mod.MasterEndpoints(a.base, token="sekrit").request("GET", "/shards")
    return (answer, a.headers_seen[0].get("Authorization"),
            b.headers_seen[0].get("Authorization"))


SCENARIOS = {
    "comma list parsing": (_comma_list, (["http://a:1", "http://b:2"],
                                         ("raised", "ValueError", False, False))),
    "failover skips a dead replica": (_failover_skips_dead, ((200, "ok"), 2)),
    "a 307 is followed with the POST body": (
        _follows_307, (200, {"echo": {"targets": [{"pod": "x"}]}}, True)),
    "a 503 fails over once, then is the answer": (
        _503_once, ((200, "served"), (503, "unowned too"))),
    "a 4xx is an answer, not a failover": (_4xx_is_an_answer, ((404, "no pod"), [])),
    "a POST fails over on connection refused": (_post_on_refused, (200, "ok")),
    "a timed-out POST does not fail over": (
        _post_timeout, (("raised", "EndpointError", True, False), 0, (200, "served"))),
    "all dead raises EndpointError": (_all_dead, ("raised", "EndpointError", False, False)),
    # urllib follows a GET's 307 itself (up to its own bound) inside each hop
    "a redirect loop is bounded": (_redirect_loop, (("raised", "EndpointError", False, True), 20)),
    "the bearer survives a redirect": (
        _auth_survives_redirect, ((200, "ok"), "Bearer sekrit", "Bearer sekrit")),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_a_failover_case_runs_as_the_references(case):
    scenario, want = SCENARIOS[case]
    seen = _run(scenario)
    assert seen["port"] == seen["reference"] == want
