"""The gray-failure health plane (``gpumounter_tpu_torch/health/plane.py``)
against the reference's (``gpumounter_tpu/health/plane.py``).

Each case of ``tests/test_health.py`` (but the three of the share packer and
the defrag planner, which come with their packages) is a function of a
side: the reference's package or the port's, under the same names. It runs
on both, and what each returns (states, panes without their clocks, the
flight recorder's ``health`` records, counter deltas, raised errors) must be
equal, and the reference test's own expectations must hold on the port's.
Then the state machine on seeded sequences of fixed node entries (no clock
in them), the HTTP routes, the warm pool's drain on a quarantined pull, the
canary's default probe over the worker path, and the two failpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import types

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.health import plane as ref_plane
from gpumounter_tpu.k8s import fake as ref_fake
from gpumounter_tpu.k8s import health as ref_k8s_health
from gpumounter_tpu.obs import flight as ref_flight
from gpumounter_tpu.store import KubeMasterStore as RefKubeMasterStore
from gpumounter_tpu.store.cache import CachedMasterStore as RefCachedMasterStore
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.health import plane
from gpumounter_tpu_torch.k8s import fake
from gpumounter_tpu_torch.k8s import health as k8s_health
from gpumounter_tpu_torch.obs import flight
from gpumounter_tpu_torch.store import CachedMasterStore, KubeMasterStore

SIDES = {
    "reference": types.SimpleNamespace(
        kind="reference", plane=ref_plane, Plane=ref_plane.HealthPlane,
        Prober=ref_plane.CanaryProber, fp=ref_failpoints, FLIGHT=ref_flight.FLIGHT,
        Fake=ref_fake.FakeKubeClient, Store=RefKubeMasterStore, Cached=RefCachedMasterStore,
        ApiHealth=ref_k8s_health.ApiHealth, cfg=lambda **kw: RefConfig().replace(**kw)),
    "port": types.SimpleNamespace(
        kind="port", plane=plane, Plane=plane.HealthPlane, Prober=plane.CanaryProber,
        fp=failpoints, FLIGHT=flight.FLIGHT, Fake=fake.FakeKubeClient, Store=KubeMasterStore,
        Cached=CachedMasterStore, ApiHealth=k8s_health.ApiHealth,
        cfg=lambda **kw: dataclasses.replace(Config(), **kw)),
}

#: tests/test_health.py's knobs
KNOBS = dict(health_enabled=True, health_min_samples=3, health_p95_multiplier=3.0,
             health_p95_floor_ms=20.0, health_error_ratio=0.25, health_suspect_strikes=2,
             health_quarantine_strikes=3, health_clear_passes=2, health_rehab_canary_passes=2,
             health_probation_passes=2, health_drain_burn_passes=2,
             health_quarantine_budget=0.10, health_min_fresh_fraction=0.5)


def _cfg(side, **over):
    return side.cfg(**{**KNOBS, **over})


def _entry(p95=10.0, count=10, success=10, error=0, breaker="closed", **extra):
    e = {"mount": {"count": count, "p95_ms": p95, "success": success, "error": error},
         "breaker": breaker}
    e.update(extra)
    return e


def _fleet(special=None, herd=3):
    nodes = {f"h-{i}": _entry() for i in range(herd)}
    nodes.update(special or {})
    return nodes


def _state(p, node):
    return p.payload()["nodes"][node]["state"]


def _pane(p, node):
    """The node's pane without its clock."""
    out = dict(p.payload()["nodes"][node])
    out.pop("since")
    return out


def _payload(p):
    out = p.payload()
    out["nodes"] = {n: {k: v for k, v in pane.items() if k != "since"}
                    for n, pane in out["nodes"].items()}
    out["last_pass"] = {k: v for k, v in out["last_pass"].items() if k != "at"}
    return out


def _records(side, node=None):
    return [(r.get("node"), r["details"]["from_state"], r["details"]["to_state"],
             r["details"]["signals"], r["summary"])
            for r in side.FLIGHT.snapshot()
            if r["kind"] == "health" and (node is None or r.get("node") == node)]


def _raises(fn):
    try:
        fn()
    except ValueError as exc:
        return f"ValueError: {exc}"
    return None


class _Registry:
    def __init__(self, snap):
        self._snap = dict(snap)

    def registry_snapshot(self):
        return dict(self._snap)


class _DeadRecovery:
    def __init__(self, dead=()):
        self.dead = set(dead)

    def is_evacuated(self, node):
        return node in self.dead


# --- the cases: each a function of a side, returning what is compared ---

def p95_outlier_drives_suspect_then_quarantine(side):
    p = side.Plane(_cfg(side))
    states = []
    for _ in range(3):
        p.observe(_fleet({"limpy": _entry(200.0)}))
        states.append(_state(p, "limpy"))
    pane = p.payload()
    return (states, p.is_quarantined("limpy"), sorted(p.excluded_hosts()),
            pane["last_pass"]["verdict"], pane["last_pass"]["median_p95_ms"],
            pane["nodes"]["limpy"]["signals"], _records(side, "limpy"))


def outlier_needs_min_samples(side):
    p = side.Plane(_cfg(side))
    for _ in range(6):
        p.observe(_fleet({"limpy": _entry(500.0, count=2, success=1, error=1)}))
    return _state(p, "limpy")


def outlier_needs_a_herd(side):
    p = side.Plane(_cfg(side))
    nodes = {"h-0": _entry(count=0, success=0), "h-1": _entry(count=0, success=0),
             "limpy": _entry(500.0)}
    for _ in range(6):
        p.observe(nodes)
    return _state(p, "limpy"), p.payload()["last_pass"]["median_p95_ms"]


def error_ratio_signal(side):
    p = side.Plane(_cfg(side))
    for _ in range(3):
        p.observe(_fleet({"flaky": _entry(10.0, success=5, error=5)}))
    return _pane(p, "flaky")


def single_bad_pass_clears_back_to_zero(side):
    p = side.Plane(_cfg(side))
    p.observe(_fleet({"limpy": _entry(200.0)}))
    for _ in range(2):
        p.observe(_fleet({"limpy": _entry()}))
    p.observe(_fleet({"limpy": _entry(200.0)}))
    return _pane(p, "limpy")


def full_cycle_through_probation_without_canary(side):
    p = side.Plane(_cfg(side))
    seen = []
    for entry in [_entry(200.0)] * 3 + [_entry()] * 4:
        p.observe(_fleet({"limpy": entry}))
        seen.append((_state(p, "limpy"), sorted(p.excluded_hosts()),
                     sorted(p.probation_hosts())))
    return seen, _records(side, "limpy")


def probation_flapback_requarantines_without_budget(side):
    herd = {f"h-{i}": _entry() for i in range(9)}
    p = side.Plane(_cfg(side))
    for _ in range(3):
        p.observe(dict(herd, limpy=_entry(200.0)))
    for _ in range(2):
        p.observe(dict(herd, limpy=_entry()))
    before = _state(p, "limpy")
    p.quarantine("h-0", reason="operator judgement")
    p.observe(dict(herd, limpy=_entry(200.0)))
    return before, _state(p, "limpy"), p.payload()["quarantine_budget"]


def drain_recommendation_after_slo_burn(side):
    p = side.Plane(_cfg(side))
    for _ in range(3):
        p.observe(_fleet({"limpy": _entry(200.0)}))
    before = p.payload()["nodes"]["limpy"]["drain_recommended"]
    for _ in range(2):
        p.observe(_fleet({"limpy": _entry(200.0)}))
    return before, _pane(p, "limpy"), _records(side, "limpy")


def fail_open_on_stale_collector(side):
    p = side.Plane(_cfg(side))
    p.observe(_fleet({"limpy": _entry(200.0)}))
    skips = side.plane.SCORER_SKIPS._values.get((), 0.0)
    p.observe({"h-0": {"stale": True}, "h-1": {"stale": True},
               "h-2": {"error": "unreachable"}, "limpy": _entry(200.0)})
    skipped = side.plane.SCORER_SKIPS._values.get((), 0.0) - skips
    verdict = dict(p.payload()["last_pass"])
    verdict.pop("at")
    p.observe(_fleet({"limpy": _entry(200.0)}))
    return skipped, verdict, _state(p, "limpy")


def disabled_plane_is_inert(side):
    p = side.Plane(_cfg(side, health_enabled=False))
    for _ in range(6):
        p.observe(_fleet({"limpy": _entry(500.0)}))
    return _payload(p), sorted(p.excluded_hosts())


def excluded_hosts_degrades_to_empty_set(side):
    p = side.Plane(_cfg(side))
    p.quarantine("limpy", reason="x")

    class _BrokenLock:
        def __enter__(self):
            raise RuntimeError("lock plane broke")

        def __exit__(self, *exc):
            return False

    p._lock = _BrokenLock()
    return sorted(p.excluded_hosts()), sorted(p.probation_hosts())


def budget_caps_automatic_quarantine(side):
    herd = {f"h-{i}": _entry() for i in range(8)}
    p = side.Plane(_cfg(side))
    denials = side.plane.BUDGET_DENIALS._values.get((), 0.0)
    for _ in range(3):
        p.observe(dict(herd, **{"limp-a": _entry(200.0), "limp-b": _entry(200.0)}))
    return (_state(p, "limp-a"), _state(p, "limp-b"),
            side.plane.BUDGET_DENIALS._values.get((), 0.0) - denials,
            p.payload()["quarantine_budget"])


def manual_quarantine_exempt_from_budget_and_sticky(side):
    herd = {f"h-{i}": _entry() for i in range(8)}
    p = side.Plane(_cfg(side))
    for _ in range(3):
        p.observe(dict(herd, **{"limp-a": _entry(200.0), "limp-b": _entry(200.0)}))
    pane = dict(p.quarantine("limp-b", reason="nvme timeouts", actor="oncall"))
    pane.pop("since")
    excluded = sorted(p.excluded_hosts())
    for _ in range(6):
        p.observe(dict(herd, **{"limp-a": _entry(), "limp-b": _entry()}))
    states = _state(p, "limp-a"), _state(p, "limp-b")
    released = dict(p.release("limp-b", actor="oncall"))
    released.pop("since")
    return pane, excluded, states, released, _records(side)


def release_refuses_nodes_that_are_not_quarantined(side):
    return _raises(lambda: side.Plane(_cfg(side)).release("never-seen"))


def breaker_open_counts_without_canary_evidence(side):
    p = side.Plane(_cfg(side))
    for _ in range(2):
        p.observe(_fleet({"tripped": _entry(10.0, breaker="open")}))
    return _pane(p, "tripped")


def breaker_canary_dedupe_one_incident_one_signal(side):
    p = side.Plane(_cfg(side))
    p.record_canary("tripped", ok=False, detail="mount refused")
    p.observe(_fleet({"tripped": _entry(10.0, breaker="open")}))
    first = _pane(p, "tripped")
    p.record_canary("tripped", ok=True)
    p.observe(_fleet({"tripped": _entry(10.0, breaker="open")}))
    return first, _pane(p, "tripped")


def evacuation_supersedes_quarantine(side):
    p = side.Plane(_cfg(side))
    p.quarantine("limpy", reason="slow")
    p.note_evacuated("limpy")
    return (sorted(p.excluded_hosts()), _pane(p, "limpy"),
            _raises(lambda: p.release("limpy")),
            _raises(lambda: p.quarantine("limpy", reason="again")), _records(side))


def release_refuses_recovery_evacuated_node(side):
    p = side.Plane(_cfg(side), recovery=_DeadRecovery(dead={"limpy"}))
    p.quarantine("limpy", reason="slow")
    return _raises(lambda: p.release("limpy"))


def canary_probes_only_the_decision_relevant_set(side):
    p = side.Plane(_cfg(side))
    for _ in range(2):
        p.observe(_fleet({"limpy": _entry(200.0), "skippy": _entry(200.0)}, herd=4))
    probed = []

    def probe(node, address):
        probed.append((node, address))
        if node == "skippy":
            return None, "canary pod not scheduled"
        return False, "slow rpc"

    reg = _Registry({"limpy": "10.0.0.1", "skippy": "10.0.0.2", "h-0": "10.0.0.3"})
    prober = side.Prober(p, reg, None, cfg=p.cfg, probe=probe)
    return (prober.targets(), prober.probe_once(), sorted(probed),
            _pane(p, "limpy")["canary"], _pane(p, "skippy")["canary"])


def canary_gates_rehab_when_active(side):
    p = side.Plane(_cfg(side))
    p.canary_active = True
    for _ in range(3):
        p.observe(_fleet({"limpy": _entry(200.0)}))
    for _ in range(4):
        p.observe(_fleet({"limpy": _entry()}))
    held = _state(p, "limpy")
    p.record_canary("limpy", ok=True)
    p.record_canary("limpy", ok=True)
    p.observe(_fleet({"limpy": _entry()}))
    return held, _state(p, "limpy"), _records(side, "limpy")


def canary_probe_exception_is_evidence(side):
    p = side.Plane(_cfg(side))
    for _ in range(2):
        p.observe(_fleet({"limpy": _entry(200.0)}))

    def probe(node, address):
        raise ConnectionError("dial tcp: connection refused")

    prober = side.Prober(p, _Registry({"limpy": "10.0.0.1"}), None, cfg=p.cfg, probe=probe)
    return prober.probe_once(), _pane(p, "limpy")["canary"]


def quarantine_survives_master_restart_via_store(side):
    cfg = _cfg(side)
    store = side.Store(side.Fake(), cfg)
    side.Plane(cfg, store=store).quarantine("node-q", reason="nvme timeouts", actor="oncall")
    second = side.Plane(cfg, store=store)
    restored = second.load()
    quarantined, pane = second.is_quarantined("node-q"), _pane(second, "node-q")
    second.release("node-q")
    return restored, quarantined, pane, side.Plane(cfg, store=store).load()


def store_load_fails_open_on_garbage(side):
    cfg = _cfg(side)
    kube = side.Fake()
    kube.create_lease(cfg.worker_namespace, {
        "metadata": {"name": side.Store.HEALTH_LEASE, "namespace": cfg.worker_namespace,
                     "annotations": {side.Store.ANNOT_HEALTH: "{not json"}},
        "spec": {}})
    store = side.Store(kube, cfg)
    return store.load_health_state(), side.Plane(cfg, store=store).load()


def cached_store_delegates_health_state(side):
    cfg = _cfg(side, writebehind_dir="")
    store = side.Cached(side.Store(side.Fake(), cfg), cfg=cfg, apihealth=side.ApiHealth(cfg=cfg))
    state = {"version": 1, "nodes": {"n": {"state": "quarantined", "since": 1.0,
                                           "reason": "r", "manual": False}}}
    store.save_health_state(state)
    loaded = store.load_health_state()
    store.close() if hasattr(store, "close") else None
    return loaded


def health_observe_failpoint_is_armable(side):
    p = side.Plane(_cfg(side))
    side.fp.arm("health.observe", "pdrop(1.0)")
    try:
        p.observe(_fleet())
        raised = None
    except side.fp.InjectedUnavailable as exc:
        raised = type(exc).__name__
    side.fp.disarm_all()
    p.observe(_fleet())
    return raised, p.payload()["last_pass"]["verdict"]


def health_canary_failpoint_turns_into_probe_evidence(side):
    p = side.Plane(_cfg(side))
    for _ in range(2):
        p.observe(_fleet({"limpy": _entry(200.0)}))
    before = _state(p, "limpy")

    def exploding_factory(address):  # the dial must never happen
        raise AssertionError("probe dialed past the failpoint")

    prober = side.Prober(p, _Registry({"limpy": "10.0.0.1"}), exploding_factory, cfg=p.cfg)
    side.fp.arm("health.canary", "pdrop(1.0)")
    driven = prober.probe_once()
    side.fp.disarm_all()
    canary = _pane(p, "limpy")["canary"]
    return before, driven, canary["consecutive_failures"], canary["detail"].split(":")[0]


PLANE_CASES = [
    p95_outlier_drives_suspect_then_quarantine, outlier_needs_min_samples, outlier_needs_a_herd,
    error_ratio_signal, single_bad_pass_clears_back_to_zero,
    full_cycle_through_probation_without_canary, probation_flapback_requarantines_without_budget,
    drain_recommendation_after_slo_burn, fail_open_on_stale_collector, disabled_plane_is_inert,
    excluded_hosts_degrades_to_empty_set, budget_caps_automatic_quarantine,
    manual_quarantine_exempt_from_budget_and_sticky,
    release_refuses_nodes_that_are_not_quarantined, breaker_open_counts_without_canary_evidence,
    breaker_canary_dedupe_one_incident_one_signal, evacuation_supersedes_quarantine,
    release_refuses_recovery_evacuated_node, canary_probes_only_the_decision_relevant_set,
    canary_gates_rehab_when_active, canary_probe_exception_is_evidence,
    quarantine_survives_master_restart_via_store, store_load_fails_open_on_garbage,
    cached_store_delegates_health_state, health_observe_failpoint_is_armable,
    health_canary_failpoint_turns_into_probe_evidence,
]

#: tests/test_health.py's own expectations, held on the port's result
EXPECTED = {
    "outlier_needs_min_samples": "healthy",
    "outlier_needs_a_herd": ("healthy", None),
    "release_refuses_nodes_that_are_not_quarantined": "ValueError: never-seen is not quarantined",
    "excluded_hosts_degrades_to_empty_set": ([], []),
    "store_load_fails_open_on_garbage": (None, 0),
    "health_observe_failpoint_is_armable": ("InjectedUnavailable", "scoring"),
    "health_canary_failpoint_turns_into_probe_evidence": ("suspect", 1, 1,
                                                          "InjectedUnavailable"),
    "canary_probe_exception_is_evidence": (1, {"consecutive_ok": 0, "consecutive_failures": 1,
                                               "detail": "ConnectionError: dial tcp: "
                                                         "connection refused"}),
}


@pytest.mark.parametrize("case", PLANE_CASES, ids=lambda c: c.__name__)
def test_a_plane_case_runs_as_the_references(case):
    got = {}
    for name, side in SIDES.items():
        side.FLIGHT.reset()
        side.fp.disarm_all()
        got[name] = case(side)
    assert got["port"] == got["reference"]
    if case.__name__ in EXPECTED:
        assert got["port"] == EXPECTED[case.__name__]
    port = got["port"]
    if case is p95_outlier_drives_suspect_then_quarantine:
        assert port[0] == ["healthy", "suspect", "quarantined"] and port[1] is True
        assert port[3:5] == ("scoring", 10.0)
        assert any(s.startswith("mount_p95_outlier") for s in port[5])
        assert port[6][-1][2] == "quarantined" and port[6][-1][3]
    elif case is full_cycle_through_probation_without_canary:
        assert [s for s, _, _ in port[0]] == ["healthy", "suspect", "quarantined", "quarantined",
                                              "rehabilitating", "rehabilitating", "healthy"]
        assert port[0][4][1:] == ([], ["limpy"])
    elif case is probation_flapback_requarantines_without_budget:
        assert port[:2] == ("rehabilitating", "quarantined") and port[2]["used"] == 2
    elif case is budget_caps_automatic_quarantine:
        assert port[:3] == ("quarantined", "suspect", 1.0)
        assert port[3]["max_nodes"] == 1 and port[3]["used"] == 1
    elif case is manual_quarantine_exempt_from_budget_and_sticky:
        assert port[0]["state"] == "quarantined" and port[0]["manual"] is True
        assert port[1] == ["limp-a", "limp-b"] and port[2] == ("healthy", "quarantined")
        assert port[3]["state"] == "healthy" and port[3]["manual"] is False
    elif case is breaker_canary_dedupe_one_incident_one_signal:
        assert "breaker_open" not in port[0]["signals"]
        assert any(s.startswith("canary_failures") for s in port[0]["signals"])
        assert "breaker_open" in port[1]["signals"]
    elif case is evacuation_supersedes_quarantine:
        assert port[0] == [] and port[1]["evacuated"] is True and port[2] and port[3]
    elif case is canary_probes_only_the_decision_relevant_set:
        assert port[0] == ["limpy", "skippy"] and port[1] == 1
        assert port[3] == {"consecutive_ok": 0, "consecutive_failures": 1, "detail": "slow rpc"}
    elif case is canary_gates_rehab_when_active:
        assert port[:2] == ("quarantined", "rehabilitating")
    elif case is quarantine_survives_master_restart_via_store:
        assert port[:2] == (1, True) and port[2]["manual"] and port[3] == 0
    elif case is fail_open_on_stale_collector:
        assert port[0] == 1.0 and port[1]["verdict"] == "stale" and port[2] == "suspect"
    elif case is drain_recommendation_after_slo_burn:
        assert port[0] is False and port[1]["drain_recommended"] is True


# --- the state machine on seeded fixed entries (no clock in them) ---

def _seeded_entries(rng: random.Random, n_nodes: int) -> dict[str, dict]:
    nodes = {}
    for i in range(n_nodes):
        roll = rng.random()
        if roll < 0.08:
            nodes[f"n-{i}"] = {"stale": True}
        elif roll < 0.12:
            nodes[f"n-{i}"] = {"error": "unreachable"}
        else:
            count = rng.choice([0, 2, 5, 10, 40])
            errors = rng.randint(0, count // 2) if rng.random() < 0.3 else 0
            nodes[f"n-{i}"] = _entry(p95=rng.choice([8.0, 12.0, 30.0, 90.0, 400.0]),
                                     count=count, success=count - errors, error=errors,
                                     breaker="open" if rng.random() < 0.1 else "closed")
    return nodes


@pytest.mark.parametrize("seed", [7, 1337, 20260803])
def test_the_state_machine_is_the_references_on_seeded_entries(seed):
    """Forty passes of seeded entries over 10 nodes, with seeded canary
    outcomes and operator verbs between them: both planes' panes (without
    their clocks), budgets, excluded and probation sets and flight records
    agree after every pass."""
    rng_draws = {}
    for name, side in SIDES.items():
        side.FLIGHT.reset()
        rng = random.Random(seed)
        p = side.Plane(_cfg(side, health_quarantine_budget=0.3))
        p.canary_active = seed % 2 == 1
        trail = []
        for _ in range(40):
            p.observe(_seeded_entries(rng, 10))
            for node in sorted(p.payload()["nodes"]):
                if rng.random() < 0.2:
                    p.record_canary(node, rng.random() < 0.7, detail="seeded")
            verb = rng.random()
            node = f"n-{rng.randrange(10)}"
            if verb < 0.05:
                trail.append(("quarantine", node, _raises(lambda: p.quarantine(node, "op"))))
            elif verb < 0.10:
                trail.append(("release", node, _raises(lambda: p.release(node))))
            elif verb < 0.12:
                p.note_evacuated(node)
            trail.append((_payload(p), sorted(p.excluded_hosts()), sorted(p.probation_hosts())))
        rng_draws[name] = (trail, _records(side))
    assert rng_draws["port"] == rng_draws["reference"]
    states = {pane["state"] for step in rng_draws["port"][0] if isinstance(step[0], dict)
              for pane in step[0]["nodes"].values()}
    assert {"suspect", "quarantined"} <= states


def test_the_series_are_the_references():
    for name in ("NODE_HEALTH_STATE", "CANARY_PROBES", "CANARY_FAILURES",
                 "QUARANTINE_TRANSITIONS", "SCORER_SKIPS", "BUDGET_DENIALS"):
        mine, ref = getattr(plane, name), getattr(ref_plane, name)
        assert (mine.name, mine.help, type(mine).__name__) == (ref.name, ref.help,
                                                                type(ref).__name__)
    assert plane.STATES == ref_plane.STATES


# --- probabilistic failpoints (the gray scenario's substrate) ---

@pytest.mark.parametrize("spec, ok", [
    ("pdrop(1.5)", False), ("pdelay([2.0, 0.1])", False), ("pdelay(0.5)", False),
    ("pdrop(0.5)", True), ("pdelay([0.5, 0.01])", True)])
def test_probabilistic_failpoint_specs_validate_as_the_references(spec, ok):
    for fp in (ref_failpoints, failpoints):
        if ok:
            fp.arm("t.spec", spec)
        else:
            with pytest.raises(fp.FailpointSpecError):
                fp.arm("t.spec", spec)
        fp.disarm_all()


def test_pdrop_is_seeded_and_reproducible_as_the_references():
    def draw(fp, n=32):
        fp.arm("t.pdrop", "pdrop(0.5)")
        out = []
        for _ in range(n):
            try:
                fp.fire("t.pdrop")
                out.append(False)
            except fp.InjectedUnavailable:
                out.append(True)
        fp.disarm_all()
        return out

    seqs = {}
    for fp in (ref_failpoints, failpoints):
        fp.seed(42)
        first = draw(fp)
        fp.seed(42)
        assert draw(fp) == first
        seqs[fp.__name__] = first
    port = seqs[failpoints.__name__]
    assert port == seqs[ref_failpoints.__name__]
    assert any(port) and not all(port)


def test_pdelay_full_probability_always_fires():
    import time
    failpoints.arm("t.pdelay", "pdelay([1.0, 0.02])")
    t0 = time.monotonic()
    failpoints.fire("t.pdelay")
    assert time.monotonic() - t0 >= 0.02


# --- the routes ---

def test_the_health_routes_answer_as_the_references():
    """GET /health/nodes in the read scope, POST /health/quarantine/<node>
    audited and shard-gated: quarantine, release, a second release 409, an
    unknown action 400, a body that is not JSON 400; both masters' statuses
    and panes equal."""
    from conftest import AUTH_HEADER

    from gpumounter_tpu.master.app import MasterApp as RefApp
    from gpumounter_tpu.master.app import WorkerRegistry as RefRegistry
    from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
    from gpumounter_tpu_torch.master.app import MasterApp
    from gpumounter_tpu_torch.obs.audit import AUDIT

    steps = [("GET", "/health/nodes", b"", AUTH_HEADER),
             ("GET", "/health/nodes", b"", {}),
             ("POST", "/health/quarantine/node-x",
              json.dumps({"action": "quarantine", "reason": "disk timeouts"}).encode(),
              AUTH_HEADER),
             ("POST", "/health/quarantine/node-x", json.dumps({"action": "release"}).encode(),
              AUTH_HEADER),
             ("POST", "/health/quarantine/node-x", json.dumps({"action": "release"}).encode(),
              AUTH_HEADER),
             ("POST", "/health/quarantine/node-x", json.dumps({"action": "explode"}).encode(),
              AUTH_HEADER),
             ("POST", "/health/quarantine/node-x", b"{not json", AUTH_HEADER),
             ("POST", "/health/quarantine/node-x", b"", {}),
             ("GET", "/health/nodes", b"", AUTH_HEADER)]
    got = {}
    for name, side in SIDES.items():
        kube = side.Fake()
        if name == "reference":
            registry = RefRegistry(kube, _cfg(side))
            app = RefApp(kube, cfg=_cfg(side), worker_client_factory=lambda a: None,
                         registry=registry)
            close, audit = registry.stop, REF_AUDIT
        else:
            app = MasterApp(kube, cfg=_cfg(side), worker_client_factory=lambda a: None)
            close, audit = app.close, AUDIT
        try:
            answers = []
            for method, path, body, headers in steps:
                status, _, text, _ = app.handle(method, path, body, dict(headers))
                try:
                    doc = json.loads(text)
                except ValueError:
                    doc = text.strip()
                if isinstance(doc, dict):
                    doc.pop("since", None)
                    for pane in [doc.get("health")] + list(doc.get("nodes", {}).values()):
                        if isinstance(pane, dict):
                            pane.pop("since", None)
                    doc.get("last_pass", {}).pop("at", None)
                answers.append((status, doc))
            ops = [r["operation"] for r in audit.snapshot()
                   if r["operation"] == "http.health_quarantine"]
            got[name] = (answers, len(ops))
        finally:
            close()
    assert got["port"] == got["reference"]
    statuses = [status for status, _ in got["port"][0]]
    assert statuses == [200, 401, 200, 200, 409, 400, 400, 401, 200]
    assert got["port"][0][2][1]["health"]["state"] == "quarantined"
    assert got["port"][0][2][1]["health"]["manual"] is True
    assert got["port"][1] == 5


# --- the warm pool's drain, riding a quarantined pull ---

def test_pool_drains_warm_holders_on_quarantine(tmp_path):
    """A quarantined node banks no standby capacity: the drain deletes its
    Running holders and pauses the refill, the release restocks; on both
    pools, the same counts."""
    from gpumounter_tpu.allocator.pool import WARM_SELECTOR as REF_SELECTOR
    from gpumounter_tpu.allocator.pool import WarmPodPool as RefPool
    from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
    from gpumounter_tpu_torch.allocator.pool import WARM_SELECTOR, WarmPodPool
    from gpumounter_tpu_torch.testing.cluster import FakeCluster

    def run(cluster, pool_cls, selector, cfg):
        pool = pool_cls(cluster.kube, cfg=cfg, refill_async=False)
        node = cluster.node_name
        pool.ensure_node(node)
        pool.refill_once()
        steps = [pool.ready_count(node), pool.set_drained(node, True), pool.drained(node),
                 pool.ready_count(node),
                 len(cluster.kube.list_pods(cfg.pool_namespace, label_selector=selector))]
        pool.refill_once()
        steps.append(pool.ready_count(node))
        steps.append(pool.set_drained(node, False))
        pool.refill_once()
        steps.append(pool.ready_count(node))
        pool.stop()
        return steps

    ref = RefCluster(str(tmp_path / "ref"), n_chips=4).start()
    try:
        want = run(ref, RefPool, REF_SELECTOR, ref.cfg.replace(warm_pool_size=2))
    finally:
        ref.stop()
    port = FakeCluster.with_fake_gpus(str(tmp_path / "port"), 4)
    got = run(port, WarmPodPool, WARM_SELECTOR,
              dataclasses.replace(port.cfg, warm_pool_size=2))
    assert got == want == [2, 2, True, 0, 0, 0, 0, 2]


def test_the_fleet_pull_carries_the_planes_quarantine():
    """The collector asks each node's pull with ``quarantined`` only for the
    plane's excluded hosts (the flag absent otherwise), and a plane that
    raises in its pass costs the pass nothing."""
    from gpumounter_tpu_torch.obs.fleet import FleetCollector

    calls = []

    class _Client:
        def __init__(self, address):
            self.address = address

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def collect_telemetry(self, **kwargs):
            calls.append((self.address, kwargs))
            return types.SimpleNamespace(telemetry=json.dumps(
                {"schema": "tpumounter-telemetry/1", "node": "", "counters": {},
                 "mount_latency": {"buckets": [], "count": 0, "sum": 0.0, "exemplars": []}}))

    cfg = dataclasses.replace(Config(), **KNOBS)
    p = plane.HealthPlane(cfg)
    p.quarantine("n-1", reason="limping")
    collector = FleetCollector(_Registry({"n-0": "10.0.0.1", "n-1": "10.0.0.2"}), _Client,
                               cfg=cfg)
    collector.health = p
    collector.collect_once()
    assert sorted(calls) == [(f"10.0.0.1:{cfg.worker_port}", {}),
                             (f"10.0.0.2:{cfg.worker_port}", {"quarantined": True})]
    assert p.payload()["last_pass"]["verdict"] == "scoring"
    failpoints.arm("health.observe", "pdrop(1.0)")
    assert set(collector.collect_once()["nodes"]) == {"n-0", "n-1"}


def test_health_check_on_the_cpu():
    """``entry.health_check("cpu")`` on a fake host of 2 GPUs, through the
    master and the worker over gRPC: the drain on the quarantined pull, the
    canary healthy with this process among its holders, the vanished node
    unhealthy, the scorer's path back to healthy, and the worker's death
    evacuated with its bookings released and the release refused: that
    worker a child process, killed with SIGKILL."""
    from gpumounter_tpu_torch.entry import health_check
    from gpumounter_tpu_torch.rpc.resilience import BREAKER_TRIPS
    from gpumounter_tpu_torch.utils.metrics import MOUNT_TOTAL

    # the check opens the breaker twice; the process's series of breaker trips
    # is read whole by the fleet rollup's tests, so it is left as it was. The
    # scorer reads the worker's mount counters, which in one process are also
    # every earlier test's (a test file that failed 15 of 30 mounts before it
    # reads as a node's mount_error_ratio): the check starts from none, and
    # they are put back after
    trips, mounts = dict(BREAKER_TRIPS._values), dict(MOUNT_TOTAL._values)
    MOUNT_TOTAL._values.clear()
    try:
        report = health_check("cpu")
    finally:
        BREAKER_TRIPS._values.clear()
        BREAKER_TRIPS._values.update(trips)
        MOUNT_TOTAL._values.clear()
        MOUNT_TOTAL._values.update(mounts)
    h = report["fake"]
    assert report["live"] is None
    m = h["manual"]
    assert m["drained"] == 1 and m["pane"]["state"] == "healthy"
    chip = m["clean"]["probe"]["chips"][0]
    assert chip["healthy"] and chip["holder_count"] >= 1
    lost = m["vanished"]["probe"]["chips"][0]
    assert not lost["healthy"] and lost["reason"] == (
        "injected device node vanished from target /dev")
    assert m["vanished"]["canary"]["consecutive_failures"] == 1
    assert h["scored"]["states"] == ["suspect", "quarantined", "quarantined", "rehabilitating",
                                     "rehabilitating", "healthy"]
    assert [(r["from"], r["to"]) for r in h["records"]] == [
        ("healthy", "quarantined"), ("quarantined", "healthy"), ("healthy", "suspect"),
        ("suspect", "quarantined"), ("quarantined", "rehabilitating"),
        ("rehabilitating", "healthy")]
    assert h["records"][2]["signals"] == ["breaker_open"]
    d = h["death"]
    assert d["released"] and d["passes"] >= 2 and "evacuated" in d["release_refused"]
    assert d["pid"] != os.getpid() and d["spawn_ms"] > 0


# --- the share packer: the health plane's placement consumer ---


def _share_packer(side):
    from gpumounter_tpu.vchip import packer as ref_packer
    from gpumounter_tpu.vchip import shares as ref_shares
    from gpumounter_tpu_torch.vchip import packer, shares
    pmod, smod = (ref_packer, ref_shares) if side.kind == "reference" else (packer, shares)
    cfg = _cfg(side)
    return pmod, pmod.SharePacker(smod.ShareRegistry(cfg=cfg), cfg=cfg)


def test_packer_hard_excludes_quarantined_hosts():
    """``excluded_hosts`` (the plane's quarantined) is a hard exclusion:
    their GPUs are never candidates, even when the refusal is the
    alternative; as the reference's."""
    got = {}
    for name, side in SIDES.items():
        pmod, packer = _share_packer(side)
        with pytest.raises(pmod.PackRefused) as err:
            packer.admit("default", "p", "balanced", 1, 50, inventory={"chip-q": "node-q"},
                         excluded_hosts={"node-q"})
        booked = packer.admit("default", "p", "balanced", 1, 50,
                              inventory={"chip-q": "node-q", "chip-ok": "node-ok"},
                              excluded_hosts={"node-q"})
        got[name] = (str(err.value), [s.chip_uuid for s in booked])
    assert got["port"] == got["reference"]
    assert got["port"][1] == ["chip-ok"]


def test_packer_probation_hosts_rank_last_but_stay_placeable():
    got = {}
    for name, side in SIDES.items():
        _, packer = _share_packer(side)
        inventory = {"a-rehab": "node-r", "b-clear": "node-ok"}
        first = packer.admit("default", "p", "balanced", 1, 50, inventory=inventory,
                             probation_hosts={"node-r"})
        # probation beats a refusal when it is all that is left
        second = packer.admit("default", "q", "balanced", 1, 60, inventory=inventory,
                              probation_hosts={"node-r"})
        got[name] = ([s.chip_uuid for s in first], [s.chip_uuid for s in second])
    assert got["port"] == got["reference"] == (["b-clear"], ["a-rehab"])
