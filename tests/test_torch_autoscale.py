"""The autoscaler of the port against the reference's.

The counterparts of ``tests/test_autoscale.py``'s 26 cases, each run on both
packages where its inputs are the same, and compared:

  * the throughput model: the fits' r_max, b_half and rmse (relative 1e-9),
    the derived samples and the verdicts;
  * the controller over the reference's fakes: every pass record and
    decision key for key (``at`` and ``trace_id`` left out), the store's
    puts, the defragmenter fake's calls, the refusals' causes, statuses and
    messages, and the audit records;
  * the routes on a bare master of each package: the same codes, bodies and
    Retry-After.

The NVSwitch form of the grow's feasibility (ROADMAP §3, "The NVSwitch
autoscaler") is pinned beside the reference's verdict on the same inputs: a
host's free GPUs are one block, so free {0, 3} or {0, 3, 5, 6} place a grow
that the reference's ICI grid defers to a defrag. The reference's deferred
grow is built here from a warm GPU instead (free {0}, warm {3}), where both
forms defer. Also: the config keys, the ``autoscale.pass`` failpoint and the
fleet collector's ``throughput`` observer.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import secrets
import types

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

import gpumounter_tpu.autoscale as ref_autoscale
import gpumounter_tpu_torch.autoscale as port_autoscale
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.elastic.intents import Intent as RefIntent
from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.obs import capacity as ref_capacity
from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.elastic.intents import Intent
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.obs.audit import AUDIT

SIDES = ("reference", "port")


def _pkg(side: str) -> types.SimpleNamespace:
    """One package's autoscaler, intent, config, failpoints and audit."""
    if side == "reference":
        return types.SimpleNamespace(
            mod=ref_autoscale, Intent=RefIntent, failpoints=ref_failpoints, audit=REF_AUDIT,
            cfg=lambda **kw: RefConfig().replace(**kw), ceiling="max_tpu_per_request")
    return types.SimpleNamespace(
        mod=port_autoscale, Intent=Intent, failpoints=failpoints, audit=AUDIT,
        cfg=lambda **kw: dataclasses.replace(Config(), **kw), ceiling="max_gpu_per_request")


def _plain(value):
    """A record with its clock and trace ids left out, intents as tuples."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items() if k not in ("at", "trace_id")}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (RefIntent, Intent)):
        return ("intent", value.desired_chips, value.min_chips, value.priority)
    return value


def _both(scenario) -> dict:
    """scenario(side) on each package; their plain outputs must be equal."""
    out = {side: scenario(side) for side in SIDES}
    assert _plain(out["port"]) == _plain(out["reference"])
    return out


# --- the throughput model ---


def _mm_series(batches, r_max=100.0, b_half=10.0, noise=()):
    """(batch, rate) pairs on a saturating curve, with an optional relative
    noise cycled over the points."""
    out = []
    for i, b in enumerate(batches):
        r = r_max * b / (b + b_half)
        if noise:
            r *= 1.0 + noise[i % len(noise)]
        out.append((float(b), r))
    return out


def _feed(model, tenant, series, t0=1000.0, dt=10.0):
    """Cumulative snapshots, one step a sample, d_tokens == batch. Returns
    the last snapshot and the samples observe derived."""
    steps, tokens, at = 0.0, 0.0, t0
    derived = [model.observe(tenant, {"steps": {"count": steps}, "tokens_total": tokens,
                                      "at": at, "tokens_per_s": 0.0})]
    snap = None
    for batch, rate in series:
        steps += 1
        tokens += batch
        at += dt
        snap = {"steps": {"count": steps}, "tokens_total": tokens, "at": at,
                "tokens_per_s": rate}
        derived.append(model.observe(tenant, snap))
    return snap, derived


def _same_fit(ref: dict | None, port: dict | None) -> None:
    assert (ref is None) == (port is None)
    if ref is None:
        return
    assert port["plateau_only"] == ref["plateau_only"]
    for key in ("r_max", "b_half", "rmse"):
        assert port[key] == pytest.approx(ref[key], rel=1e-9, abs=1e-12), key


def test_fit_curve_recovers_saturating_params():
    fits = {side: _pkg(side).mod.fit_curve(_mm_series([5, 10, 20, 40, 80, 160]))
            for side in SIDES}
    _same_fit(fits["reference"], fits["port"])
    fit = fits["port"]
    assert not fit["plateau_only"]
    assert fit["r_max"] == pytest.approx(100.0, rel=0.01)
    assert fit["b_half"] == pytest.approx(10.0, rel=0.05)
    assert fit["rmse"] < 1.0
    rates = [port_autoscale.predict(fit, b) for b in (1, 8, 64, 512)]
    assert rates == sorted(rates) and rates[-1] < fit["r_max"]
    assert rates == [ref_autoscale.predict(fits["reference"], b) for b in (1, 8, 64, 512)]


def test_fit_curve_survives_noise():
    series = _mm_series([4, 8, 16, 32, 64, 128, 256], noise=(0.04, -0.03, 0.02, -0.05))
    fits = {side: _pkg(side).mod.fit_curve(series) for side in SIDES}
    _same_fit(fits["reference"], fits["port"])
    assert fits["port"]["r_max"] == pytest.approx(100.0, rel=0.25)
    assert fits["port"]["b_half"] > 0.0


def test_fit_curve_plateau_fallback_on_flat_batches():
    """Equal batches carry no curvature: the mean-rate plateau, never an
    unbounded r_max."""
    series = [(32.0, 90.0), (32.0, 92.0), (32.0, 88.0)]
    fits = {side: _pkg(side).mod.fit_curve(series) for side in SIDES}
    _same_fit(fits["reference"], fits["port"])
    fit = fits["port"]
    assert fit["plateau_only"] and fit["r_max"] == pytest.approx(90.0) and fit["b_half"] == 0.0
    assert port_autoscale.predict(fit, 1) == port_autoscale.predict(fit, 1024) == fit["r_max"]


def test_model_derives_deltas_and_rebaselines_on_reset():
    def scenario(side):
        p = _pkg(side)
        model = p.mod.ThroughputModel(cfg=p.cfg(), clock=lambda: 2000.0)
        last, derived = _feed(model, "ns/a", _mm_series([10, 20, 40, 80]))
        fit = model.fit("ns/a", now=last["at"])
        assert fit["verdict"] == "ok" and fit["samples"] == 4
        # a restarted tenant's counters restart: re-baselined, no sample
        reset = {"steps": {"count": 1.0}, "tokens_total": 40.0, "at": last["at"] + 10,
                 "tokens_per_s": 80.0}
        assert model.observe("ns/a", reset) is None
        nxt = {"steps": {"count": 2.0}, "tokens_total": 120.0, "at": last["at"] + 20,
               "tokens_per_s": 88.0}
        sample = model.observe("ns/a", nxt)
        assert sample == (last["at"] + 20, 80.0, 88.0)
        return {"derived": derived, "fit": fit, "sample": sample}

    _both(scenario)


def test_model_verdicts_sparse_stale_untracked():
    def scenario(side):
        p = _pkg(side)
        cfg = p.cfg()
        model = p.mod.ThroughputModel(cfg=cfg)
        verdicts = [model.fit("ns/ghost", now=0.0)["verdict"]]
        last, _ = _feed(model, "ns/a", _mm_series([10, 20]))
        verdicts.append(model.fit("ns/a", now=last["at"])["verdict"])
        last, _ = _feed(model, "ns/b", _mm_series([10, 20, 40, 80, 160]))
        verdicts.append(model.fit("ns/b", now=last["at"])["verdict"])
        verdicts.append(model.fit("ns/b", now=last["at"] + cfg.autoscale_stale_s + 1.0)
                        ["verdict"])
        assert verdicts == ["untracked", "sparse", "ok", "stale"]
        pane = model.payload(now=last["at"])
        assert pane["tracked"] == 2 and pane["tenants"]["ns/b"]["verdict"] == "ok"
        return {"verdicts": verdicts, "pane": pane}

    _both(scenario)


def test_model_tenant_table_is_bounded():
    def scenario(side):
        p = _pkg(side)
        model = p.mod.ThroughputModel(cfg=p.cfg(autoscale_max_tenants=2))
        for i in range(4):
            _feed(model, f"ns/t{i}", _mm_series([10, 20]))
        tracked = model.payload(now=1020.0)["tracked"]
        assert tracked == 2 and model.overflow_dropped > 0
        model.forget("ns/t0")
        _feed(model, "ns/fresh", _mm_series([10, 20]))
        assert "ns/fresh" in model.payload(now=1020.0)["tenants"]
        return {"tracked": tracked, "dropped": model.overflow_dropped,
                "pane": model.payload(now=1020.0)}

    _both(scenario)


# --- the controller's fakes (the reference's) ---


class _FakeStore:
    def __init__(self, intents=None):
        self.intents = dict(intents or {})
        self.puts = []

    def put(self, namespace, pod_name, intent):
        self.intents[(namespace, pod_name)] = intent
        self.puts.append((namespace, pod_name, intent))
        return intent

    def list(self):
        return [(ns, pod, i) for (ns, pod), i in sorted(self.intents.items())]


class _FakeElastic:
    def __init__(self, store):
        self.store = store
        self.enqueued = []

    def enqueue(self, namespace, pod_name):
        self.enqueued.append((namespace, pod_name))


class _FakeFleet:
    def __init__(self, nodes):
        self.nodes = nodes
        self.fail = None

    def payload(self, max_age_s=None):
        if self.fail is not None:
            raise self.fail
        return {"nodes": self.nodes}


class _BurningSlo:
    def evaluate(self):
        return {"burn_threshold": 2.0, "objectives": [
            {"name": "tenant-disruption-free-minutes", "breached": False, "burn_fast": 3.5},
            {"name": "slice-feasibility", "burn_fast": 9.0}]}


class _BrokenSlo:
    def evaluate(self):
        raise RuntimeError("slo store corrupt")


class _DeadApi:
    def ok(self):
        return False

    def state(self):
        return "down"


class _FlakyApi:
    """ok() answers from a script: the mid-pass degradation."""

    def __init__(self, answers):
        self.answers = list(answers)

    def ok(self):
        return self.answers.pop(0) if self.answers else False

    def state(self):
        return "healthy" if self.answers else "down"


class _FakeHealth:
    def __init__(self, excluded=()):
        self.excluded = frozenset(excluded)

    def excluded_hosts(self):
        return self.excluded


class _FakeDefrag:
    def __init__(self, moves=1):
        self.calls = []
        self.moves = moves

    def plan(self):
        self.calls.append("plan")
        return {"id": "dfp-test", "moves": [{"chips": 2}] * self.moves}

    def run(self, plan_id=None):
        self.calls.append(f"run:{plan_id}")
        return {"status": "completed"}


def _node(free=(), held=None, warm=(), tenants=None):
    return {"capacity": {"free": list(free), "held": {int(i): t for i, t in (held or {}).items()},
                         "warm": list(warm), "fenced": [], "total": 8},
            "tenants": dict(tenants or {})}


def _saturated(side, nodes, tenant="default/train", queue=50.0, intents=None, cfg=None,
               **kw):
    """A controller of `side` over one saturated tenant: its curve learned
    (utilization ~0.94), its queue deep, its intent desired 4 and min 1.
    intents: {(ns, pod): (desired, min, priority)}. Returns (ctrl, store,
    elastic, now)."""
    p = _pkg(side)
    cfg = cfg or p.cfg()
    spec = intents if intents is not None else {tuple(tenant.split("/")): (4, 1, 0)}
    store = _FakeStore({key: p.Intent(desired_chips=d, min_chips=m, priority=pr)
                        for key, (d, m, pr) in spec.items()})
    elastic = _FakeElastic(store)
    now = [1100.0]  # the newest fed sample is at 1060: fresh
    ctrl = p.mod.AutoscaleController(elastic, None, _FakeFleet(nodes), cfg=cfg,
                                     clock=lambda: now[0], **kw)
    last, _ = _feed(ctrl.model, tenant, _mm_series([5, 10, 20, 40, 80, 160]))
    for entry in nodes.values():
        entry["tenants"][tenant] = {**last, "queue_depth": queue}
    return ctrl, store, elastic, now


def _refusal(ctrl, side) -> dict:
    """evaluate_once's refusal as {cause, status, message}."""
    with pytest.raises(_pkg(side).mod.AutoscaleRefused) as exc:
        ctrl.evaluate_once()
    return {"cause": exc.value.cause, "status": exc.value.status, "message": str(exc.value)}


# --- the controller's gates ---


def test_controller_refuses_while_slo_burns():
    def scenario(side):
        ctrl, store, _, _ = _saturated(side, {"h1": _node(range(8))}, slo=_BurningSlo())
        refused = _refusal(ctrl, side)
        assert refused["cause"] == "slo-burn" and refused["status"] == 503
        # slice-feasibility alone never gates
        assert "tenant-disruption-free-minutes" in refused["message"]
        assert "slice-feasibility" not in refused["message"]
        records = _pkg(side).audit.query(operation="autoscale.pass")
        assert any(e["outcome"] == "refused: slo-burn" for e in records)
        return {"refused": refused, "puts": store.puts,
                "outcomes": [e["outcome"] for e in records]}

    _both(scenario)


def test_controller_fails_closed_when_slo_engine_breaks():
    def scenario(side):
        ctrl, _, _, _ = _saturated(side, {"h1": _node(range(8))}, slo=_BrokenSlo())
        refused = _refusal(ctrl, side)
        assert refused["cause"] == "slo-burn" and "slo-engine-error" in refused["message"]
        return refused

    _both(scenario)


def test_controller_parks_under_degraded_api():
    def scenario(side):
        ctrl, _, _, _ = _saturated(side, {"h1": _node(range(8))}, apihealth=_DeadApi())
        refused = _refusal(ctrl, side)
        assert refused["cause"] == "api-degraded" and refused["status"] == 503
        return refused

    _both(scenario)


def test_controller_refuses_while_paused():
    def scenario(side):
        ctrl, store, _, _ = _saturated(side, {"h1": _node(range(8))})
        paused = ctrl.pause(actor="test")
        refused = _refusal(ctrl, side)
        assert refused["cause"] == "paused" and store.puts == []
        resumed = ctrl.resume(actor="test")
        record = ctrl.evaluate_once()  # the pass runs again
        return {"paused": paused, "refused": refused, "resumed": resumed, "record": record}

    _both(scenario)


def test_midpass_api_degradation_parks_at_tenant_boundary():
    """The API dies between tenants: the first tenant's evaluation stands,
    the rest of the pass parks."""
    def scenario(side):
        intents = {("default", "aaa"): (2, 1, 0), ("default", "bbb"): (2, 1, 0)}
        # ok(): the top of the pass, aaa's boundary, bbb's boundary (down)
        ctrl, _, _, _ = _saturated(side, {"h1": _node(range(8))}, intents=intents,
                                   apihealth=_FlakyApi([True, True, False]))
        record = ctrl.evaluate_once()
        assert record["status"] == "parked-api" and record["considered"] == 1
        assert len(record["decisions"]) == 1
        return record

    _both(scenario)


def test_fleet_failure_refuses_not_scales_blind():
    def scenario(side):
        ctrl, _, elastic, _ = _saturated(side, {"h1": _node(range(8))})
        ctrl.fleet.fail = RuntimeError("collector wedged")
        refused = _refusal(ctrl, side)
        assert refused["cause"] == "stale-telemetry" and refused["status"] == 503
        assert elastic.enqueued == []
        return refused

    _both(scenario)


def test_armed_failpoint_aborts_the_pass():
    """The declared ``autoscale.pass`` site, armed: a pass that dies at the
    top leaves no decision, and the one-shot action leaves the next clean."""
    def scenario(side):
        p = _pkg(side)
        ctrl, store, _, _ = _saturated(side, {"h1": _node(range(8))})
        p.failpoints.arm("autoscale.pass", "1*error(chaos autoscale abort)")
        try:
            with pytest.raises(Exception, match="chaos autoscale abort"):
                ctrl.evaluate_once()
            assert store.puts == [] and p.failpoints.hits("autoscale.pass") == 1
            return ctrl.evaluate_once()
        finally:
            p.failpoints.disarm_all()

    _both(scenario)


# --- the controller's decisions ---


def test_grow_fires_after_hysteresis_with_audit_and_trace():
    def scenario(side):
        p = _pkg(side)
        ctrl, store, elastic, _ = _saturated(side, {"h1": _node(range(8))})
        first = ctrl.evaluate_once()
        (d1,) = first["decisions"]
        assert d1["action"] == "hold" and d1["reason"] == "hysteresis" and d1["streak"] == 1
        assert store.puts == []
        second = ctrl.evaluate_once()
        (d2,) = second["decisions"]
        assert d2["action"] == "grow" and (d2["from_chips"], d2["to_chips"]) == (4, 6)
        assert d2["feasibility"]["verdict"] == "admissible" and d2["trace_id"]
        ((ns, pod, intent),) = store.puts
        assert (ns, pod) == ("default", "train")
        assert (intent.desired_chips, intent.min_chips) == (6, 1)
        assert elastic.enqueued == [("default", "train")]
        (entry,) = p.audit.query(operation="autoscale.decision")
        assert entry["details"]["action"] == "grow" and entry["trace_id"] == d2["trace_id"]
        pane = ctrl.payload()
        assert [d["action"] for d in pane["decisions"]] == ["grow"]
        assert "default/train" in pane["cooldowns"]
        return {"passes": [first, second], "puts": store.puts, "enqueued": elastic.enqueued,
                "audit": {k: entry[k] for k in ("operation", "actor", "namespace", "pod",
                                                 "outcome", "details")},
                "pane": pane}

    _both(scenario)


def test_cooldown_blocks_back_to_back_decisions():
    def scenario(side):
        ctrl, store, _, now = _saturated(side, {"h1": _node(range(8))})
        records = [ctrl.evaluate_once(), ctrl.evaluate_once()]  # the grow fires
        assert len(store.puts) == 1
        records.append(ctrl.evaluate_once())  # the streak builds again first
        assert records[-1]["decisions"][0]["reason"] == "hysteresis"
        for _ in range(3):  # saturated, inside the cooldown
            records.append(ctrl.evaluate_once())
            (d,) = records[-1]["decisions"]
            assert d["action"] == "hold" and d["reason"] == "cooldown"
        assert len(store.puts) == 1
        now[0] += float(ctrl.cfg.autoscale_cooldown_s) + 1.0
        # the cooldown has run out, and the telemetry is stale by then
        records.append(ctrl.evaluate_once())
        (d,) = records[-1]["decisions"]
        assert d["reason"] == "stale-telemetry" and len(store.puts) == 1
        return {"records": records, "puts": store.puts}

    _both(scenario)


def test_interrupted_signal_restarts_hysteresis():
    """N passes in a row: a steady pass between two saturated ones restarts
    the streak."""
    def scenario(side):
        nodes = {"h1": _node(range(8))}
        ctrl, store, _, _ = _saturated(side, nodes)
        records = [ctrl.evaluate_once()]
        nodes["h1"]["tenants"]["default/train"]["queue_depth"] = 10.0
        records.append(ctrl.evaluate_once())
        assert records[-1]["decisions"][0]["reason"] == "steady"
        nodes["h1"]["tenants"]["default/train"]["queue_depth"] = 50.0
        records.append(ctrl.evaluate_once())
        assert records[-1]["decisions"][0]["reason"] == "hysteresis"
        assert records[-1]["decisions"][0]["streak"] == 1 and store.puts == []
        return records

    _both(scenario)


def test_stale_telemetry_holds_never_actuates():
    def scenario(side):
        ctrl, store, _, now = _saturated(side, {"h1": _node(range(8))})
        now[0] += float(ctrl.cfg.autoscale_stale_s) + 200.0
        records = [ctrl.evaluate_once() for _ in range(4)]
        for record in records:
            (d,) = record["decisions"]
            assert d["action"] == "hold" and d["reason"] == "stale-telemetry"
        assert store.puts == []
        return records

    _both(scenario)


def test_shrink_never_goes_below_the_floor():
    """An idle tenant shrinks by steps to its min_chips and then holds
    at-floor."""
    def scenario(side):
        p = _pkg(side)
        cfg = p.cfg(autoscale_hysteresis=1, autoscale_cooldown_s=0.0)
        ctrl, store, _, now = _saturated(side, {"h1": _node(range(8))}, tenant="default/idle",
                                         queue=0.0, intents={("default", "idle"): (4, 2, 0)},
                                         cfg=cfg)
        # its batch collapsed: the rate sits low on the learned curve
        for entry in ctrl.fleet.nodes.values():
            snap = entry["tenants"]["default/idle"]
            snap["tokens_per_s"] = 100.0 * 5.0 / 15.0
            snap["steps"] = {"count": snap["steps"]["count"] + 1}
            snap["tokens_total"] = snap["tokens_total"] + 5.0
            snap["at"] = now[0]
        records = [ctrl.evaluate_once()]
        (d,) = records[-1]["decisions"]
        assert d["action"] == "shrink" and d["to_chips"] == 2
        records.append(ctrl.evaluate_once())
        (d,) = records[-1]["decisions"]
        assert d["action"] == "hold" and d["reason"] == "at-floor"
        assert len(store.puts) == 1
        return {"records": records, "puts": store.puts}

    _both(scenario)


def test_grow_infeasible_when_only_quarantined_hosts_fit():
    """The only host with room is quarantined: infeasible; lifted, the grow
    fires (after the hysteresis the infeasible hold restarted)."""
    def scenario(side):
        nodes = {"sick": _node(range(8)), "full": _node([], {i: "ns/x" for i in range(8)})}
        ctrl, store, _, _ = _saturated(side, nodes, health=_FakeHealth(excluded={"sick"}))
        records = [ctrl.evaluate_once(), ctrl.evaluate_once()]
        (d,) = records[-1]["decisions"]
        assert d["action"] == "hold" and d["reason"] == "infeasible"
        assert d["feasibility"]["verdict"] == "infeasible"
        assert d["feasibility"]["excluded_hosts"] == 1 and store.puts == []
        ctrl.health = _FakeHealth()
        records += [ctrl.evaluate_once(), ctrl.evaluate_once()]
        assert records[-1]["decisions"][0]["action"] == "grow"
        return {"records": records, "puts": store.puts}

    _both(scenario)


def _warm_blocked():
    """One 8-GPU host, free {0} and warm {3}, six GPUs held: a grow of 2 fits
    the free and warm GPUs together but not the free ones alone, on either
    form."""
    return {"frag": _node([0], {1: "ns/x", 2: "ns/x", 4: "ns/x", 5: "ns/x", 6: "ns/x",
                                7: "ns/x"}, warm=[3])}


def test_grow_after_defrag_requests_a_plan_and_defers():
    """The reference's case builds its blocked host from two ICI singletons
    (free {0, 3}); NVSwitch has none, so the port's blocks it with a warm
    holder. The grow defers, asks the defragmenter for a plan and runs it;
    nothing actuates."""
    def scenario(side):
        defrag = _FakeDefrag()
        ctrl, store, _, _ = _saturated(side, _warm_blocked(), defrag=defrag)
        records = [ctrl.evaluate_once(), ctrl.evaluate_once()]
        (d,) = records[-1]["decisions"]
        assert d["action"] == "hold" and d["deferred"] == "requested-defrag"
        assert d["feasibility"]["verdict"] == "admissible-after-defrag"
        assert defrag.calls == ["plan", "run:dfp-test"] and store.puts == []
        return {"records": records, "calls": defrag.calls}

    _both(scenario)


def test_two_ici_singletons_grow_on_nvswitch():
    """Pinned (ROADMAP §3): the reference's own input of the deferred grow,
    free {0, 3} with six GPUs held. The reference defers to a defrag; on
    NVSwitch the two free GPUs are one block, and the grow fires."""
    out = {}
    for side in SIDES:
        defrag = _FakeDefrag()
        nodes = {"frag": _node([0, 3], {1: "ns/x", 2: "ns/x", 4: "ns/x", 5: "ns/x",
                                        6: "ns/x", 7: "ns/x"})}
        ctrl, store, _, _ = _saturated(side, nodes, defrag=defrag)
        ctrl.evaluate_once()
        (d,) = ctrl.evaluate_once()["decisions"]
        out[side] = (d["action"], d["feasibility"]["verdict"], defrag.calls, len(store.puts))
    assert out["reference"] == ("hold", "admissible-after-defrag", ["plan", "run:dfp-test"], 0)
    assert out["port"] == ("grow", "admissible", [], 1)


@pytest.mark.parametrize("free, held, need, reference, port", [
    ((0, 3, 5, 6), (1, 2, 4, 7), 2, ("admissible", 1, 0), ("admissible", 1, 0)),
    ((0, 3, 5, 6), (1, 2, 4, 7), 3, ("admissible-after-defrag", 0, 1), ("admissible", 1, 0)),
    ((0, 3, 5, 6), (1, 2, 4, 7), 4, ("admissible-after-defrag", 0, 1), ("admissible", 1, 0)),
    ((0, 3), (1, 2, 4, 5, 6, 7), 2, ("admissible-after-defrag", 0, 1), ("admissible", 1, 0)),
])
def test_grow_feasibility_in_the_nvswitch_form(free, held, need, reference, port):
    """Pinned (ROADMAP §3): one 8-GPU host under the default config. A
    host's block is its free GPUs on NVSwitch, so admissible-after-defrag
    comes only from warm holders. Each row: (verdict, hosts admissible now,
    hosts after defrag) of the reference, then of the port."""
    nodes = {"h": _node(free, {i: "ns/x" for i in held})}
    got = {}
    for side in SIDES:
        ctrl = _pkg(side).mod.AutoscaleController(_FakeElastic(_FakeStore()), None,
                                                  _FakeFleet(nodes), cfg=_pkg(side).cfg())
        feas = ctrl._grow_feasibility(need, copy.deepcopy(nodes))
        got[side] = (feas["verdict"], feas["hosts_admissible_now"], feas["hosts_after_defrag"])
    assert got == {"reference": reference, "port": port}


def test_grow_holds_at_the_request_ceiling():
    """At MAX_GPU_PER_REQUEST (the reference's MAX_TPU_PER_REQUEST, 64 on
    both) the grow holds at-ceiling."""
    def scenario(side):
        p = _pkg(side)
        cfg = p.cfg()
        ceiling = int(getattr(cfg, p.ceiling))
        ctrl, store, _, _ = _saturated(side, {"h1": _node(range(8))},
                                       intents={("default", "train"): (ceiling, 1, 0)}, cfg=cfg)
        records = [ctrl.evaluate_once(), ctrl.evaluate_once()]
        (d,) = records[-1]["decisions"]
        assert d["action"] == "hold" and d["reason"] == "at-ceiling" and store.puts == []
        return {"ceiling": ceiling, "records": records}

    _both(scenario)


def _two_tenant_contention(side, priorities):
    """Two saturated tenants, one host with one free 2-GPU block: whoever is
    evaluated first claims it, and the other reads infeasible."""
    p = _pkg(side)
    cfg = p.cfg(autoscale_hysteresis=1, autoscale_cooldown_s=0.0, autoscale_max_step=2)
    intents = {("default", "aaa-batch"): (4, 1, priorities["aaa-batch"]),
               ("default", "zzz-prod"): (4, 1, priorities["zzz-prod"])}
    nodes = {"h1": _node([0, 1], {i: "default/other" for i in range(2, 8)})}
    ctrl, store, _, _ = _saturated(side, nodes, tenant="default/aaa-batch", intents=intents,
                                   cfg=cfg)
    last, _ = _feed(ctrl.model, "default/zzz-prod", _mm_series([5, 10, 20, 40, 80, 160]))
    for entry in nodes.values():
        entry["tenants"]["default/zzz-prod"] = {**last, "queue_depth": 50.0}
    return store, ctrl.evaluate_once()


def test_priority_class_wins_contended_capacity():
    """The higher priority is evaluated first and takes the only block,
    though it sorts last by name; the default class reads infeasible."""
    def scenario(side):
        store, record = _two_tenant_contention(side, {"aaa-batch": 0, "zzz-prod": 10})
        d1, d2 = record["decisions"]
        assert d1["tenant"] == "default/zzz-prod"
        assert d1["action"] == "grow" and d1["to_chips"] == 6
        assert d2["tenant"] == "default/aaa-batch"
        assert d2["action"] == "hold" and d2["reason"] == "infeasible"
        ((ns, pod, intent),) = store.puts
        assert (ns, pod) == ("default", "zzz-prod") and intent.priority == 10
        return {"record": record, "puts": store.puts}

    _both(scenario)


def test_default_priority_class_keeps_stable_order():
    """Equal classes: the alphabetical order."""
    def scenario(side):
        store, record = _two_tenant_contention(side, {"aaa-batch": 0, "zzz-prod": 0})
        d1, d2 = record["decisions"]
        assert d1["tenant"] == "default/aaa-batch" and d1["action"] == "grow"
        assert d2["tenant"] == "default/zzz-prod"
        assert d2["action"] == "hold" and d2["reason"] == "infeasible"
        ((ns, pod, _),) = store.puts
        assert (ns, pod) == ("default", "aaa-batch")
        return {"record": record, "puts": store.puts}

    _both(scenario)


# --- the config and the fleet's throughput observer ---


CONFIG_KEYS = {
    "autoscale_enabled": ("TPUMOUNTER_AUTOSCALE", False),
    "autoscale_interval_s": ("AUTOSCALE_INTERVAL_S", 60.0),
    "autoscale_cooldown_s": ("AUTOSCALE_COOLDOWN_S", 300.0),
    "autoscale_stale_s": ("AUTOSCALE_STALE_S", 120.0),
    "autoscale_min_samples": ("AUTOSCALE_MIN_SAMPLES", 4),
    "autoscale_history": ("AUTOSCALE_HISTORY", 64),
    "autoscale_max_tenants": ("AUTOSCALE_MAX_TENANTS", 256),
    "autoscale_queue_grow": ("AUTOSCALE_QUEUE_GROW", 32.0),
    "autoscale_queue_shrink": ("AUTOSCALE_QUEUE_SHRINK", 2.0),
    "autoscale_util_grow": ("AUTOSCALE_UTIL_GROW", 0.85),
    "autoscale_util_shrink": ("AUTOSCALE_UTIL_SHRINK", 0.35),
    "autoscale_hysteresis": ("AUTOSCALE_HYSTERESIS", 2),
    "autoscale_max_step": ("AUTOSCALE_MAX_STEP", 2),
}


@pytest.mark.parametrize("key", sorted(CONFIG_KEYS))
def test_the_autoscale_config_is_the_references(key, monkeypatch):
    """Each key: the reference's default, and its environment variable read
    alike by both packages."""
    env, default = CONFIG_KEYS[key]
    assert getattr(Config(), key) == getattr(RefConfig(), key) == default
    monkeypatch.setenv(env, "true" if isinstance(default, bool) else "3")
    assert getattr(Config(), key) == getattr(RefConfig(), key) != default


class _StaticWorkers:
    def __init__(self, nodes):
        self.nodes = dict(nodes)

    def registry_snapshot(self):
        return dict(self.nodes)


def test_the_fleet_collector_feeds_the_model_every_pass():
    """MasterApp's collector carries the controller's model as its
    ``throughput`` observer: each pass's tenant snapshots become samples
    (the first a baseline), and a model that raises never fails the pass."""
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.master.app import MasterApp
    from gpumounter_tpu_torch.obs.fleet import FleetCollector

    app = MasterApp(FakeKubeClient(), cfg=Config(auth_token=secrets.token_hex(8)))
    try:
        assert app.fleet.autoscale_model is app.autoscale.model
    finally:
        app.close()
    model = port_autoscale.ThroughputModel(cfg=Config(), clock=lambda: 1100.0)
    fleet = FleetCollector(_StaticWorkers({"n1": "10.0.0.1"}), None, cfg=Config())
    fleet.autoscale_model = model
    series = _mm_series([5, 10, 20, 40, 80])
    state = {"steps": 0.0, "tokens": 0.0, "at": 1000.0}

    def collect_one(node, ip):
        return node, {"mode": "rpc", "tenants": {"default/t": {
            "steps": {"count": state["steps"]}, "tokens_total": state["tokens"],
            "at": state["at"], "tokens_per_s": state.get("rate", 0.0), "queue_depth": 40.0}}}

    fleet._collect_one = collect_one
    fleet.collect_once()
    for batch, rate in series:
        state["steps"] += 1
        state["tokens"] += batch
        state["at"] += 10.0
        state["rate"] = rate
        fleet.collect_once()
    fit = model.fit("default/t")
    assert fit["verdict"] == "ok" and fit["samples"] == len(series)
    ref_model = ref_autoscale.ThroughputModel(cfg=RefConfig(), clock=lambda: 1100.0)
    _feed(ref_model, "default/t", series)
    assert _plain(fit) == _plain(ref_model.fit("default/t"))

    class _Broken:
        def observe_nodes(self, nodes):
            raise RuntimeError("model corrupt")

    fleet.autoscale_model = _Broken()
    assert "n1" in fleet.collect_once()["nodes"]


# --- the routes on a bare master ---


@pytest.fixture()
def apps():
    """Both packages' masters over their fake API servers; yields ({side:
    app}, {side: handle(method, path, body, auth=True) -> (status, text,
    headers)})."""
    from gpumounter_tpu.k8s.fake import FakeKubeClient as RefKube
    from gpumounter_tpu.master import app as ref_app
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
    from gpumounter_tpu_torch.master.app import MasterApp
    ref_plane = ref_capacity._PLANE
    token = secrets.token_hex(8)
    built = {"reference": ref_app.MasterApp(RefKube(), cfg=RefConfig(auth_token=token)),
             "port": MasterApp(FakeKubeClient(), cfg=Config(auth_token=token))}

    def handler(app):
        def handle(method, path, body=b"", auth=True):
            headers = {"Authorization": f"Bearer {token}"} if auth else {}
            status, _, text, extra = app.handle(method, path, body, headers)
            return status, text, extra
        return handle

    yield built, {side: handler(app) for side, app in built.items()}
    built["port"].close()
    ref_capacity.register_plane(ref_plane)


def test_autoscale_routes(apps):
    """GET /autoscale, the pause, an evaluate refused (409, paused), the
    resume, an evaluate that runs: the reference's codes and bodies; pause
    and resume audited."""
    _, handle = apps
    got = {side: [] for side in SIDES}
    for method, path in (("GET", "/autoscale"), ("POST", "/autoscale/pause"),
                         ("POST", "/autoscale/evaluate"), ("POST", "/autoscale/resume"),
                         ("POST", "/autoscale/evaluate")):
        for side in SIDES:
            status, text, headers = handle[side](method, path)
            body = _plain(json.loads(text)) if status == 200 else text
            # a traced route's header names its own trace
            got[side].append((status, body, {k: "<trace>" if k == "X-Tpumounter-Trace" else v
                                             for k, v in headers.items()}))
    assert got["port"] == got["reference"]
    assert [g[0] for g in got["port"]] == [200, 200, 409, 200, 200]
    pane, paused, refused, resumed, record = (g[1] for g in got["port"])
    assert pane["gates"]["api_ok"] is True and pane["paused"] is False
    assert pane["model"] == {"tenants": {}, "tracked": 0, "overflow_dropped": 0}
    assert paused["paused"] is True and resumed["paused"] is False
    assert "operator-paused" in refused
    assert record["status"] == "completed"
    status, text, _ = handle["port"]("POST", "/autoscale/evaluate")
    assert json.loads(text)["trace_id"]
    for side in SIDES:
        ops = [e["operation"] for e in _pkg(side).audit.snapshot()]
        assert "autoscale.pause" in ops and "autoscale.resume" in ops, side


def test_autoscale_mutate_routes_require_auth(apps):
    _, handle = apps
    for path in ("/autoscale/pause", "/autoscale/resume", "/autoscale/evaluate"):
        assert [handle[side]("POST", path, b"{}", auth=False)[0] for side in SIDES] \
            == [401, 401], path
    assert [handle[side]("GET", "/autoscale", auth=False)[0] for side in SIDES] == [401, 401]


def test_autoscale_route_parks_with_retry_after(apps):
    built, handle = apps
    for app in built.values():
        app.autoscale.slo = _BurningSlo()
    got = {side: handle[side]("POST", "/autoscale/evaluate", b"{}") for side in SIDES}
    for side in SIDES:
        assert got[side][2].pop("X-Tpumounter-Trace")
    assert got["port"] == got["reference"]
    status, text, headers = got["port"]
    assert status == 503 and "refusing to scale into a breach" in text
    assert headers == {"Retry-After": "60"}


def test_autoscale_check_on_the_cpu():
    """``entry.autoscale_check`` on the fake host of 1 GPU: the stand-in
    tenant's curve (AUTOSCALE_CPU_CURVE) found again from its four published
    windows, as the reference's fit finds it from the same (batch, rate)
    pairs; a utilization of 0.889 and a queue of 64 hold for the hysteresis
    and then find the held GPU's fleet infeasible; the pause refuses with
    409 and the resume clears it."""
    from gpumounter_tpu_torch import entry
    flows = entry.autoscale_check("cpu")["fake"]
    fit, curve = flows["fit"], entry.AUTOSCALE_CPU_CURVE
    assert fit["verdict"] == "ok" and fit["samples"] == 4
    assert fit["r_max"] == pytest.approx(curve["r_max"], rel=1e-9)
    assert fit["b_half"] == pytest.approx(curve["b_half"], rel=1e-9)
    pairs = [(w["B"] * entry.AUTOSCALE_ROW, w["tokens_per_s"])
             for w in flows["tenant"]["windows"][1:]]
    ref = ref_autoscale.fit_curve(pairs)
    assert (fit["r_max"], fit["b_half"]) == (round(ref["r_max"], 3), round(ref["b_half"], 3))
    assert fit["utilization"] == 0.889 and flows["expected"] == ["hysteresis", "infeasible"]
    assert [e["reason"] for e in flows["evaluate"]] == flows["expected"]
    assert flows["evaluate"][1]["feasibility"]["verdict"] == "infeasible"
    assert {k: v[0] for k, v in flows["pause"].items()} == {
        "pause": 200, "paused": 409, "resume": 200, "resumed": 200}
    assert len(flows["collect_ms"]) == len(entry.AUTOSCALE_WINDOWS)
    vs = flows["fit_vs_windows"]
    assert [r["B"] for r in vs["windows"]] == list(entry.AUTOSCALE_WINDOWS[1:])
    assert max(r["rel_err"] for r in vs["windows"]) < 1e-6
    assert vs["refit_err"] < entry.AUTOSCALE_REFIT_RTOL
    assert vs["r_max_over_seen"] == pytest.approx(
        curve["r_max"] / max(w["tokens_per_s"] for w in flows["tenant"]["windows"]), rel=1e-6)


#: the card's windows of a B1, B1, B2, B4, B8 tenant (tokens/s) and the fit
#: the model made of them, as phase 21 of chip_smoke.py read them on an H100
CARD_WINDOWS = [661276.4, 666114.2, 1233218.7, 2576681.0, 3336427.1]
CARD_FIT = {"r_max": 11437743.214, "b_half": 33109.483}


@pytest.mark.parametrize("fit, holds", [
    (CARD_FIT, True),
    ({**CARD_FIT, "r_max": 1.01 * CARD_FIT["r_max"]}, False),
    ({**CARD_FIT, "r_max": 2 * CARD_FIT["r_max"]}, False),
    ({**CARD_FIT, "b_half": 0.5 * CARD_FIT["b_half"]}, False),
], ids=["the-cards-fit", "r_max-off-by-1%", "r_max-doubled", "b_half-halved"])
def test_the_fit_is_held_against_its_windows(fit, holds):
    """``entry._fit_vs_windows``: the card's own fit is numpy's refit of its
    windows, and the report gives each window's miss and the plateau's
    distance past the fastest; a plateau 1% off the refit, twice as high,
    or a b_half halved is refused."""
    from gpumounter_tpu_torch import entry
    windows = [{"B": b, "tokens_per_s": r} for b, r in zip(entry.AUTOSCALE_WINDOWS,
                                                           CARD_WINDOWS)]
    if holds:
        vs = entry._fit_vs_windows(fit, windows)
        assert vs["refit_err"] < entry.AUTOSCALE_REFIT_RTOL
        assert [round(r["rel_err"], 4) for r in vs["windows"]] == [0.0002, 0.0211, 0.1196,
                                                                    0.1348]
        assert 3.4 < vs["r_max_over_seen"] < 3.5
    else:
        with pytest.raises(RuntimeError, match="against the tenant's windows"):
            entry._fit_vs_windows(fit, windows)


@pytest.mark.parametrize("b8", [4.0, 5.0, 6.0, 7.0, 8.0])
@pytest.mark.parametrize("b4", [3.5, 3.8, 4.0])
def test_the_refit_meets_the_models_fit_over_the_cards_shapes(b4, b8):
    """numpy's refit in ``entry._fit_vs_windows`` against the model's own fit
    over the shapes an H100 tenant's B1, B2, B4, B8 windows take (rate
    linear while a step costs the host's launches, flat once the forward
    costs more): B2 2 x B1's rate, B4 3.5-4 x, B8 4-8 x. B4 at 4 x and B8 at
    8 x is a line, where both fall back to the mean rate as the plateau."""
    from gpumounter_tpu_torch import entry
    rates = [6e5 * m for m in (1.0, 1.0, 2.0, b4, b8)]
    fit = ref_autoscale.fit_curve([(b * entry.AUTOSCALE_ROW, r) for b, r in
                                   zip(entry.AUTOSCALE_WINDOWS[1:], rates[1:])])
    vs = entry._fit_vs_windows(fit, [{"B": b, "tokens_per_s": r}
                                     for b, r in zip(entry.AUTOSCALE_WINDOWS, rates)])
    assert vs["refit_err"] < 1e-9
    assert fit["plateau_only"] == ((b4, b8) == (4.0, 8.0))
