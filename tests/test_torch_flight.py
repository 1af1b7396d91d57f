"""The flight recorder, on the reference's and on the port's.

The same records go into both packages' recorders, and ``query`` and
``query_from_params`` answer the same parameters the same (sequence numbers
masked); the capacity, the marker fold and the counter by kind; the JSONL
spill and its self-disabling; the span exporter (root and error spans only)
and the audit hook, each installed once however often ``install`` runs; and
the master's /timeline route with its filters and its token, on both
masters. The ApiHealth hook and the recovery markers wait for their sources.
"""

from __future__ import annotations

import json

import pytest
from conftest import AUTH_HEADER
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.obs import audit as ref_audit
from gpumounter_tpu.obs import flight as ref_flight
from gpumounter_tpu.obs import trace as ref_trace
from gpumounter_tpu_torch.obs import audit, flight, trace

SIDES = {"reference": (ref_flight, ref_trace, ref_audit), "port": (flight, trace, audit)}


def _records(rec):
    rec.record("span", "http.add ok", node="n1", trace_id="t1", at=10.0, span_id="s")
    rec.record("audit", "worker.AddGPU -> Success", node="n1", trace_id="t1", at=11.0)
    rec.record("event", "GPUMounted: 1 GPU", node="n2", trace_id="t2", at=12.0)
    rec.record("apihealth", "kube API healthy -> degraded", at=13.0)
    rec.record("something-weird", "folded", at=9.0)
    rec.record("recovery", "evacuated n2", node="n2", at=12.0)


QUERIES = [{}, {"node": ["n1"]}, {"trace": ["t1"]}, {"kind": ["event"]}, {"kind": ["marker"]},
           {"from": ["11.5"]}, {"to": ["11.5"]}, {"from": ["10.5"], "to": ["12.5"]},
           {"limit": ["2"]}, {"limit": ["0"]}, {"node": ["n2"], "limit": ["1"]},
           {"node": ["x", "n2"]}]


def _masked(records):
    return [{**r, "seq": None} for r in records]


@pytest.mark.parametrize("params", QUERIES, ids=[json.dumps(q) for q in QUERIES])
def test_the_timeline_and_its_queries_are_the_references(params):
    got = {}
    for name, (mod, _, _) in SIDES.items():
        rec = mod.FlightRecorder()
        _records(rec)
        got[name] = _masked(mod.query_from_params(params, recorder=rec)["records"])
    assert got["port"] == got["reference"]


def test_bad_parameters_raise_on_both():
    for mod, _, _ in SIDES.values():
        for params in ({"from": ["junk"]}, {"to": ["x"]}, {"limit": ["junk"]}):
            with pytest.raises(ValueError):
                mod.query_from_params(params, recorder=mod.FlightRecorder())


def test_capacity_the_counter_and_the_ambient_trace_id_are_the_references():
    from gpumounter_tpu.obs.flight import FLIGHT_RECORDS as REF_RECORDS
    from gpumounter_tpu_torch.obs.flight import FLIGHT_RECORDS
    got = {}
    for (name, (mod, tr, _)), counter in zip(SIDES.items(), (REF_RECORDS, FLIGHT_RECORDS),
                                             strict=True):
        before = {k: counter.get(kind=k) for k in ("marker", "event")}
        rec = mod.FlightRecorder(capacity=3)
        for i in range(5):
            rec.record("something-weird", f"m{i}", at=float(i))
        rec.record("event", "e", at=9.0)
        with tr.span("ambient") as ctx:
            inside = rec.record("marker", "inside")
        got[name] = (_masked([{**r, "at": None, "trace_id": bool(r["trace_id"])}
                              for r in rec.query()]),
                     {k: counter.get(kind=k) - v for k, v in before.items()},
                     inside["trace_id"] == ctx.trace_id, sorted(mod.KINDS))
    assert got["port"] == got["reference"]
    assert got["port"][1] == {"marker": 6.0, "event": 1.0}


def test_the_spill_is_the_references_and_disables_itself(tmp_path):
    got = {}
    for name, (mod, _, _) in SIDES.items():
        rec = mod.FlightRecorder()
        spill = tmp_path / f"{name}.jsonl"
        rec.configure_jsonl(str(spill))
        rec.record("marker", "one", at=1.0)
        rec.record("marker", "two", at=2.0)
        rec.configure_jsonl(str(tmp_path / "no-such-dir" / "f.jsonl"))
        rec.record("marker", "three", at=3.0)
        got[name] = (_masked([json.loads(x) for x in spill.read_text().splitlines()]),
                     rec._jsonl.broken, [r["summary"] for r in rec.query()])
    assert got["port"] == got["reference"]
    assert got["port"][1] is True


def test_the_hooks_record_roots_errors_and_audits_once_as_the_references():
    got = {}
    for name, (mod, tr, au) in SIDES.items():
        mod.FLIGHT.reset()
        mod.install()
        mod.install()  # idempotent: nothing is recorded twice
        with tr.span("edge-op"):
            with tr.span("child-ok"):
                pass
        with pytest.raises(RuntimeError):
            with tr.span("edge-2"):
                with tr.span("child-bad"):
                    raise RuntimeError("boom")
        au.AUDIT.record("worker.AddGPU", namespace="default", pod="p1", outcome="Success",
                        trace_id="t-aud")
        # sorted: an audit record's time is kept to the millisecond, a span's
        # to the microsecond, so their order within one millisecond is chance
        got[name] = sorted((r["kind"], r["summary"].split(" (")[0], bool(r["trace_id"]),
                            sorted(r.get("details", {})))
                           for r in mod.FLIGHT.query(limit=100))
        mod.FLIGHT.reset()
    assert got["port"] == got["reference"]
    assert [s for _, s, _, _ in got["port"]] == [
        "worker.AddGPU -> Success [default/p1]", "child-bad error", "edge-2 error", "edge-op ok"]


def _timeline_app(name):
    if name == "reference":
        from gpumounter_tpu.config import Config as RefConfig
        from gpumounter_tpu.k8s.fake import FakeKubeClient as RefKube
        from gpumounter_tpu.master.app import MasterApp as RefApp
        return RefApp(RefKube(), cfg=RefConfig())
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.master.app import MasterApp
    return MasterApp(FakeKubeClient())


@pytest.mark.parametrize("path", ["/timeline", "/timeline?node=n1", "/timeline?from=55",
                                  "/timeline?from=junk", "/timeline?kind=marker&limit=1"])
def test_the_timeline_route_is_the_references(path):
    got = {}
    for name, (mod, _, _) in SIDES.items():
        mod.FLIGHT.reset()
        mod.FLIGHT.record("marker", "drill start", node="n1", trace_id="t1", at=50.0)
        mod.FLIGHT.record("marker", "drill end", node="n2", at=60.0)
        app = _timeline_app(name)
        try:
            status, ctype, body, headers = app.handle("GET", path, b"", dict(AUTH_HEADER))
            refused = app.handle("GET", path, b"", {})[0]
        finally:
            app.registry.stop()
        records = _masked(json.loads(body)["records"]) if status == 200 else body.split(":")[0]
        # untraced: no header, no span
        got[name] = (status, ctype, records, "X-Tpumounter-Trace" in headers, refused)
        mod.FLIGHT.reset()
    assert got["port"] == got["reference"]
    assert got["port"][3:] == (False, 401)
