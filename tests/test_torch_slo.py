"""The SLO engine (``gpumounter_tpu_torch/obs/slo.py``) against the
reference's (``gpumounter_tpu/obs/slo.py``).

Both engines take the same seeded sequences of fleet rollups on the same
injected clock, and every evaluation (burn rates over both windows, SLIs,
verdicts) must be equal, counter resets clamped to zero burn included. A
breach fires once, with its audit record inside a span, its Event (the
port's reason ``GPUSLOBurnRate``, the reference's ``TPUSLOBurnRate``, the
same message, naming the same dominant phase of the same spans) and its
series. ``objectives_from_config`` takes and refuses the same declarations;
its defaults are the reference's but the one that comes with the capacity
plane.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.obs import audit as ref_audit
from gpumounter_tpu.obs import slo as ref_slo
from gpumounter_tpu.obs import trace as ref_trace
from gpumounter_tpu.utils.metrics import REGISTRY as REF_REGISTRY
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.obs import audit, slo, trace
from gpumounter_tpu_torch.obs.flight import FLIGHT
from gpumounter_tpu_torch.utils.metrics import REGISTRY

SLO_KNOBS = dict(slo_fast_window_s=1.0, slo_slow_window_s=2.0, slo_burn_threshold=2.0)


class _Kube:
    def __init__(self):
        self.events = []

    def create_event(self, namespace, manifest):
        self.events.append((namespace, manifest))


def _engines(clock, kube=(None, None), **knobs):
    """(reference engine, port engine) on one clock, over the same default
    objectives."""
    knobs = {**SLO_KNOBS, **knobs}
    return (ref_slo.SloEngine(cfg=RefConfig().replace(**knobs), kube=kube[0],
                              objectives=ref_slo.DEFAULT_OBJECTIVES,
                              clock=lambda: clock[0]),
            slo.SloEngine(cfg=Config(**knobs), kube=kube[1], clock=lambda: clock[0]))


def _rollup(count=0, buckets=(), success=0.0, error=0.0, heals=0.0, heal_failures=0.0,
            clean=0.0, disrupted=0.0, downtime=None, feasible=0.0, infeasible=0.0):
    return {"fleet": {"mount_count": count, "mount_buckets": [list(b) for b in buckets],
                      "mount_success": success, "mount_error": error},
            "master": {"heals": heals, "heal_failures": heal_failures,
                       "slice_feasible": feasible, "slice_infeasible": infeasible},
            "tenants_fleet": {"tenant_clean_minutes": clean,
                              "tenant_disrupted_minutes": disrupted,
                              "downtime": downtime or {}}}


def _random_rollups(seed: int, n: int = 30):
    """(dt, rollup) steps: cumulative counts that grow, with a reset now and
    then (a worker's restart)."""
    rng = np.random.default_rng(seed)
    # the capacity plane's evaluations: 9 shapes a pass, some denied
    feasibility = np.random.default_rng(seed + 1000)
    feasible = infeasible = 0.0
    fast = slow = success = error = heals = fails = clean = bad = windows = quick = 0.0
    out = []
    for _ in range(n):
        if rng.random() < 0.1:
            fast = slow = success = error = 0.0
        new = float(rng.integers(0, 20))
        good_share = float(rng.choice([1.0, 0.97, 0.5, 0.0]))
        fast += round(new * good_share)
        slow += new - round(new * good_share)
        ok = float(rng.integers(0, 10))
        success += ok
        error += float(rng.integers(0, 2)) if rng.random() < 0.3 else 0.0
        heals += float(rng.integers(0, 2))
        fails += float(rng.integers(0, 2)) if rng.random() < 0.2 else 0.0
        clean += float(rng.integers(0, 5))
        bad += float(rng.integers(0, 2)) if rng.random() < 0.2 else 0.0
        windows += float(rng.integers(0, 3))
        quick = min(windows, quick + float(rng.integers(0, 3)))
        downtime = {"migration": {"buckets": [[1.0, quick], [2.5, quick], [5.0, windows]],
                                  "count": windows}}
        denied = float(feasibility.integers(0, 3)) if feasibility.random() < 0.3 else 0.0
        feasible += 9.0 - denied
        infeasible += denied
        out.append((float(rng.choice([0.1, 0.4, 0.9, 2.5])),
                    _rollup(fast + slow, [(0.025, fast), (0.05, fast), (0.1, fast + slow)],
                            success, error, heals, fails, clean, bad, downtime,
                            feasible, infeasible)))
    return out


def _unstamped(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k != "evaluated_at"}


@pytest.mark.parametrize("seed", range(4))
def test_burn_rates_and_verdicts_are_the_references_on_the_same_samples(seed):
    clock = [100.0]
    ref, port = _engines(clock)
    for dt, rollup in _random_rollups(seed):
        clock[0] += dt
        ref.ingest(rollup)
        port.ingest(rollup)
        assert _unstamped(port.evaluate()) == _unstamped(ref.evaluate())
    names = {o["name"] for o in port.evaluate()["objectives"]}
    assert names == {o.name for o in slo.DEFAULT_OBJECTIVES}


def _mount_trace(tracer_mod, tid: str, start: float):
    """An add's fixed spans into a package's ring: the edge, its rpc and the
    worker's mknod taking most of it."""
    ring = tracer_mod.TRACER.ring
    for span in ({"trace_id": tid, "span_id": "e" * 16, "parent_id": "", "name": "http.add",
                  "start": start, "duration_s": 0.1, "status": "ok"},
                 {"trace_id": tid, "span_id": "r" * 16, "parent_id": "e" * 16,
                  "name": "rpc.AddGPU", "start": start + 0.005, "duration_s": 0.09,
                  "status": "ok"},
                 {"trace_id": tid, "span_id": "w" * 16, "parent_id": "r" * 16,
                  "name": "worker.AddGPU", "start": start + 0.006, "duration_s": 0.085,
                  "status": "ok"},
                 {"trace_id": tid, "span_id": "m" * 16, "parent_id": "w" * 16,
                  "name": "mount.mknod", "start": start + 0.01, "duration_s": 0.07,
                  "status": "ok"}):
        ring.export(dict(span))


def test_a_breach_fires_once_with_its_event_record_and_series():
    clock = [100.0]
    kubes = (_Kube(), _Kube())
    ref, port = _engines(clock, kubes)
    # the port's registry is the process's: its breaches counter runs on
    # across tests, the reference's is reset after each
    breaches_before = slo.SLO_BREACHES.get(objective="mount-latency-50ms")
    for tracer_mod in (ref_trace, trace):
        _mount_trace(tracer_mod, "ab" * 16, 1000.0)
    slow_storm = _rollup(count=10, buckets=[(0.05, 0), (0.1, 10)], success=10)
    for engine in (ref, port):
        engine.ingest(slow_storm)
    out = {"reference": ref.evaluate(), "port": port.evaluate()}
    assert _unstamped(out["port"]) == _unstamped(out["reference"])
    by = {o["name"]: o for o in out["port"]["objectives"]}
    assert by["mount-latency-50ms"]["breached"] and not by["mount-success"]["breached"]
    (_, manifest), = kubes[1].events
    (_, ref_manifest), = kubes[0].events
    assert manifest["reason"] == "GPUSLOBurnRate" and ref_manifest["reason"] == "TPUSLOBurnRate"
    assert manifest["message"] == ref_manifest["message"]
    assert "fleet-dominant phase: mknod (70% of recent mount wall time across 1 trace(s))" \
        in manifest["message"]
    assert {k: v for k, v in manifest.items() if k not in ("reason", "metadata", "firstTimestamp",
                                                           "lastTimestamp")} == \
        {k: v for k, v in ref_manifest.items() if k not in ("reason", "metadata",
                                                            "firstTimestamp", "lastTimestamp")}
    (rec,) = audit.AUDIT.query(operation="slo.breach")
    (ref_rec,) = ref_audit.AUDIT.query(operation="slo.breach")
    assert rec["outcome"] == ref_rec["outcome"] == "breach: mount-latency-50ms"
    assert rec["trace_id"] and rec["details"] == ref_rec["details"]
    assert rec["details"]["dominant_phase"] == "mknod"
    assert any(r["kind"] == "event" and r["details"]["reason"] == "GPUSLOBurnRate"
               and r["details"]["posted"] for r in FLIGHT.snapshot())
    for engine in (ref, port):  # a breach that persists posts nothing more
        engine.ingest(slow_storm)
        engine.evaluate()
    assert len(kubes[1].events) == len(kubes[0].events) == 1
    assert len(audit.AUDIT.query(operation="slo.breach")) == 1
    for reg in (REGISTRY, REF_REGISTRY):
        assert 'tpumounter_slo_breached{objective="mount-latency-50ms"} 1.0' in reg.render()
    assert 'tpumounter_slo_breaches_total{objective="mount-latency-50ms"} 1.0' in \
        REF_REGISTRY.render()
    assert slo.SLO_BREACHES.get(objective="mount-latency-50ms") == breaches_before + 1


def test_a_counter_reset_clamps_to_zero_burn_in_both():
    clock = [0.0]
    engines = _engines(clock)
    for engine in engines:
        engine.ingest(_rollup(count=100, buckets=[(0.05, 100), (0.1, 100)]))
    clock[0] += 3.0
    got = []
    for engine in engines:
        engine.ingest(_rollup(count=5, buckets=[(0.05, 0), (0.1, 5)]))
        obj = engine.evaluate()["objectives"][0]
        got.append((obj["burn_fast"], obj["burn_slow"], obj["breached"]))
    assert got[0] == got[1] == (0.0, 0.0, False)


def test_no_fast_window_traffic_no_breach_in_both():
    clock = [0.0]
    engines = _engines(clock)
    for engine in engines:
        engine.ingest(_rollup(count=10, buckets=[(0.05, 0), (0.1, 10)]))
    clock[0] += 3.0
    for engine in engines:
        engine.ingest(_rollup(count=10, buckets=[(0.05, 0), (0.1, 10)]))
        assert engine.evaluate()["objectives"][0]["breached"] is False


DECLARATIONS = {
    "the defaults": "",
    "one ratio": json.dumps([{"name": "x", "kind": "ratio", "target": 0.9,
                              "good": "heals", "bad": "heal_failures"}]),
    "a tenant downtime": json.dumps([{"name": "d", "kind": "tenant-downtime", "target": 0.95,
                                      "threshold_s": 2.5, "cause": "heal"}]),
    "not JSON": "{not json",
    "not a list": '{"a": 1}',
    "a latency without threshold": json.dumps([{"name": "l", "kind": "latency",
                                                "target": 0.9}]),
    "a target past 1": json.dumps([{"name": "r", "kind": "ratio", "target": 1.5,
                                    "good": "g", "bad": "b"}]),
    "an unknown kind": json.dumps([{"name": "n", "kind": "nope", "target": 0.9}]),
    "a ratio without keys": json.dumps([{"name": "r", "kind": "ratio", "target": 0.9}]),
    "an unknown field": json.dumps([{"name": "u", "kind": "ratio", "target": 0.9,
                                     "good": "g", "bad": "b", "weight": 3}]),
}


def _declared(mod, cfg):
    try:
        return [dataclasses.asdict(o) for o in mod.objectives_from_config(cfg)]
    except (mod.ObjectiveError, TypeError) as exc:
        return type(exc).__name__


@pytest.mark.parametrize("case", list(DECLARATIONS))
def test_objectives_from_config_takes_and_refuses_what_the_reference_does(case):
    raw = DECLARATIONS[case]
    got = _declared(slo, Config(slo_objectives=raw))
    want = _declared(ref_slo, RefConfig().replace(slo_objectives=raw))
    if case == "the defaults":
        assert got == [dataclasses.asdict(o) for o in slo.DEFAULT_OBJECTIVES]
    assert got == want
    if case == "the defaults":
        assert len(got) == len(ref_slo.DEFAULT_OBJECTIVES)
        assert "slice-feasibility" in {o["name"] for o in got}
    elif case in ("one ratio", "a tenant downtime"):
        assert len(got) == 1
    else:
        assert got in ("ObjectiveError", "TypeError")
