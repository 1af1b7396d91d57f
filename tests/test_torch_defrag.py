"""The defragmenter of the port against the reference's.

The counterparts of ``tests/test_defrag.py``'s 18 cases, restated in the
NVSwitch form where their fleet is ICI geometry, plus the parity of the two
planners where the forms agree, the inputs where they differ, the
controller's ``capacity.recovered`` stamp, the health plane's excluded hosts
as non-destinations, the executor's batches and invariant 18's negative
controls:

  * the planner: where every free set, and every union of free and evicted
    GPUs the search tries, is one ICI block, the two plans are equal key for
    key; on the four pinned inputs (ROADMAP §3, "The NVSwitch
    defragmenter") they differ as pinned;
  * the controller: the gates and their fail-closed rule, an adopted plan, a
    stale one, host-disjoint groups at once, each refusal's cause, status
    and message the reference's;
  * the routes on a bare master of each package: the same codes, bodies and
    Retry-After;
  * the chaos harness (``testing/chaos.py``): a host blocked by its warm
    holders recovered by a real move, invariant 18 on the three seeds, the
    verdict flip on /capacity, the ``defrag.run`` failpoint.
"""

from __future__ import annotations

import dataclasses
import json
import secrets
import threading
import time
import types

import numpy as np
import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.config import config as ref_config
from gpumounter_tpu.defrag import DefragController as RefController
from gpumounter_tpu.defrag import DefragRefused as RefRefused
from gpumounter_tpu.defrag import PlanError as RefPlanError
from gpumounter_tpu.defrag import plan_moves as ref_plan_moves
from gpumounter_tpu.obs import capacity as ref_capacity
from gpumounter_tpu.obs.audit import AUDIT as REF_AUDIT
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.defrag import (
    DefragController,
    DefragRefused,
    PlanError,
    fleet_fragmentation_index,
    parse_hosts,
    plan_moves,
)
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.obs import capacity
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.testing.chaos import (
    DEFRAG_NODES,
    NODE_A,
    NODE_B,
    ChaosHarness,
    InvariantViolation,
)

SEEDS = [7, 1337, 20260803]

#: the two packages' planner and config, for the cases run on both
SIDES = {"reference": (ref_plan_moves, RefPlanError, RefController, RefRefused, RefConfig),
         "port": (plan_moves, PlanError, DefragController, DefragRefused, Config)}


def _cfg(side: str, **kw):
    config = SIDES[side][4]
    return config().replace(**kw) if side == "reference" else dataclasses.replace(config(), **kw)


def _entry(free, held=None, warm=()):
    return {"capacity": {"free": list(free),
                         "held": {int(i): t for i, t in (held or {}).items()},
                         "warm": list(warm), "fenced": []}}


def _blocked_fleet():
    """The NVSwitch form of the reference's ``_fragmented_fleet``: host-a
    has 2 free GPUs and 2 warm ones, so a 4-GPU block waits for one of its
    two 2-GPU tenants to move; host-b is free. Either eviction unblocks
    host-a, and minimality must pick exactly one (pinned input 2)."""
    return {"host-a": _entry([0, 1], {4: "ns/t1", 5: "ns/t1", 6: "ns/t2", 7: "ns/t2"},
                             warm=[2, 3]),
            "host-b": _entry(range(8))}


# --- the planner: parity where the forms agree, the pinned differences ---


def _one_block_fleet(rng: np.random.RandomState) -> dict:
    """2-4 hosts of 8 GPUs as four rows of two (a row is one ICI link, and
    consecutive rows are linked): a run of free rows, the others warm or one
    of two tenants' each."""
    nodes = {}
    for h in range(int(rng.randint(2, 5))):
        n_free = int(rng.randint(0, 5))
        start = int(rng.randint(0, 5 - n_free))
        rows = []
        for r in range(4):
            if start <= r < start + n_free:
                rows.append("free")
            elif rng.rand() < 0.4:
                rows.append("warm")
            else:
                rows.append(f"ns/t{h}{int(rng.randint(2))}")
        free = [2 * r + i for r in range(4) if rows[r] == "free" for i in (0, 1)]
        warm = [2 * r + i for r in range(4) if rows[r] == "warm" for i in (0, 1)]
        held = {2 * r + i: rows[r] for r in range(4) if rows[r] not in ("free", "warm")
                for i in (0, 1)}
        nodes[f"host-{h}"] = _entry(free, held, warm)
    return nodes


def _all_unions_one_block(nodes: dict) -> bool:
    """Every host's free set, and every union of it with up to 3 of its
    tenants' GPUs, is one ICI block of the reference's grid."""
    import itertools
    for entry in nodes.values():
        cap = entry["capacity"]
        free = set(cap["free"])
        tenants: dict[str, set[int]] = {}
        for i, t in cap["held"].items():
            tenants.setdefault(t, set()).add(i)
        for k in range(0, min(3, len(tenants)) + 1):
            for combo in itertools.combinations(sorted(tenants), k):
                union = free.union(*(tenants[t] for t in combo))
                if union and ref_capacity.largest_ici_block(sorted(union)) != len(union):
                    return False
    return True


def _one_block_fleets(n: int) -> list[dict]:
    rng = np.random.RandomState(20260803)
    out = []
    while len(out) < n:
        nodes = _one_block_fleet(rng)
        if _all_unions_one_block(nodes):
            out.append(nodes)
    return out


@pytest.mark.parametrize("case", range(12))
def test_plan_moves_is_the_references_on_one_ici_block_fleets(case):
    """Where every free set and every union the search tries is one ICI
    block, the reference's largest block is the port's, and its
    ``best_block`` on a run of free rows takes the lowest ones: the plans are
    equal key for key, for blocks of 2, 4 and 6 GPUs, with and without a
    cost model, a tenant budget of 2 and a quarantined host."""
    nodes = _one_block_fleets(12)[case]
    kw = dict(max_moves=8, tenant_move_budget=1 + case % 2)
    if case % 4 == 3:
        kw["non_destinations"] = {"host-1"}
    if case % 2:
        kw["cost_fn"] = lambda tenant, n: float(len(tenant)) + 0.5 * n
    for target in (2, 4, 6):
        ref, port = (SIDES[side][0](nodes, target_block=target, **kw) for side in SIDES)
        assert port == ref, target


def test_the_parity_fleets_plan_moves():
    """The parity fleets are not all no-ops: some plan moves on both."""
    moved = [bool(plan_moves(nodes, target_block=target, max_moves=8)["moves"])
             for nodes in _one_block_fleets(12) for target in (2, 4, 6)]
    assert sum(moved) >= 3


#: ROADMAP §3's four smallest inputs (target 4, max_moves 8, 8-GPU hosts):
#: the reference's plan and the port's, as (blocked hosts, moves as
#: (pod, dest node, dest indices), skipped reasons, index before and after)
PINNED = {
    "fragmented": (
        {"host-a": _entry([0, 1, 4, 5], {2: "ns/t1", 3: "ns/t1", 6: "ns/t2", 7: "ns/t2"}),
         "host-b": _entry(range(8))},
        (["host-a"], [("t1", "host-b", [0, 1])], [], 0.1667, 0.0),
        ([], [], [], 0.0, 0.0)),
    "warm-two-tenants": (
        _blocked_fleet(),
        (["host-a"], [], ["would-raise-fragmentation"], 0.0, 0.0),
        (["host-a"], [("t1", "host-b", [0, 1])], [], 0.0, 0.0)),
    "warm-one-tenant": (
        {"host-a": _entry([0, 1], {i: "ns/t1" for i in (4, 5, 6, 7)}, warm=[2, 3]),
         "host-b": _entry(range(8))},
        (["host-a"], [], ["would-raise-fragmentation"], 0.0, 0.0),
        (["host-a"], [("t1", "host-b", [0, 1, 2, 3])], [], 0.0, 0.0)),
    "agree": (
        {"host-a": _entry([2, 3], {4: "ns/t1", 5: "ns/t1", 6: "ns/t2", 7: "ns/t2"},
                          warm=[0, 1]),
         "host-b": _entry([0, 1], {i: "ns/f" for i in range(2, 8)})},
        (["host-a"], [("t1", "host-b", [0, 1])], [], 0.0, 0.0),
        (["host-a"], [("t1", "host-b", [0, 1])], [], 0.0, 0.0)),
}


def _summary(plan: dict) -> tuple:
    return (plan["blocked_hosts"],
            [(m["pod"], m["dest_node"], m["dest_indices"]) for m in plan["moves"]],
            [s["reason"] for s in plan["skipped"]],
            plan["fragmentation_before"], plan["fragmentation_after"])


@pytest.mark.parametrize("name", list(PINNED))
def test_the_pinned_inputs_where_the_nvswitch_planner_differs(name):
    """The difference on purpose: on NVSwitch a move cannot break the
    destination's block, so the port moves where the reference refuses with
    would-raise-fragmentation (inputs 2, 3), and the reference's fragmented
    host (input 1) is admissible on the port; input 4 plans alike."""
    nodes, ref_want, port_want = PINNED[name]
    assert _summary(ref_plan_moves(nodes, target_block=4, max_moves=8)) == ref_want
    assert _summary(plan_moves(nodes, target_block=4, max_moves=8)) == port_want
    if name == "agree":
        assert plan_moves(nodes, target_block=4, max_moves=8) == \
            ref_plan_moves(nodes, target_block=4, max_moves=8)


def test_the_fleet_index_is_the_nvswitch_block_and_stays_zero():
    """fleet_fragmentation_index keeps the reference's formula over the
    NVSwitch block: 0 on any fleet, so the would-raise-fragmentation refusal
    cannot fire on the port."""
    for nodes in [p[0] for p in PINNED.values()] + _one_block_fleets(12):
        assert fleet_fragmentation_index(parse_hosts(nodes)) == 0.0
        plan = plan_moves(nodes, target_block=4, max_moves=8)
        assert "would-raise-fragmentation" not in {s["reason"] for s in plan["skipped"]}


class _FleetStub:
    def __init__(self, nodes):
        self.nodes = nodes

    def payload(self, max_age_s=None):
        return {"at": time.time(), "nodes": self.nodes}


@pytest.mark.parametrize("nodes", [
    _blocked_fleet(),
    {"host-a": _entry([0, 1], {4: "ns/t1", 5: "ns/t1", 6: "ns/t2", 7: "ns/t2"}, warm=[2, 3]),
     "host-b": _entry([0], {i: "ns/f" for i in range(1, 6)}, warm=[6, 7]),
     "host-c": _entry([0, 1, 2], {i: "ns/g" for i in range(3, 8)})},
    {"host-a": _entry([], {i: "ns/t1" for i in range(4)}, warm=[4, 5, 6, 7]),
     "host-b": _entry([0, 1, 2], {i: "ns/f" for i in range(3, 8)})},
], ids=["one-blocked", "two-blocked", "all-warm"])
def test_the_planners_blocked_hosts_are_the_capacity_planes(nodes):
    """A host is blocked when free < target <= free + warm, the capacity
    plane's admissible-after-defrag: where no host holds 4 free GPUs (so the
    nvidia-h100-80gb-4 verdict names every host in its way), the plan's
    blocked hosts are the plane's ``blocked_hosts`` and that row's."""
    plane = capacity.CapacityPlane(_FleetStub(nodes), cfg=Config())
    plan = plan_moves(nodes, target_block=4, max_moves=8)
    row = plane.payload()["feasibility"]["nvidia-h100-80gb-4"]
    if all(len(e["capacity"]["free"]) < 4 for e in nodes.values()):
        assert row["verdict"] == "admissible-after-defrag"
        assert plan["blocked_hosts"] == row["blocking_hosts"]
        assert set(plan["blocked_hosts"]) == plane.blocked_hosts()
    else:
        assert set(plan["blocked_hosts"]) <= {"host-a"}


def test_a_host_blocked_by_its_warm_pool_alone_is_skipped_by_both():
    """The gap both planners share: neither moves warm holders, so a host
    whose free and warm GPUs reach the block but that holds no tenant is
    blocked and skipped, although draining its pool would free the block."""
    nodes = {"host-a": _entry([0, 1], {}, warm=[2, 3, 4, 5]), "host-b": _entry(range(8))}
    plans = [SIDES[side][0](nodes, target_block=4, max_moves=8) for side in SIDES]
    assert plans[0] == plans[1]
    assert (plans[1]["blocked_hosts"], plans[1]["moves"], plans[1]["skipped"]) == \
        (["host-a"], [], [{"node": "host-a", "reason": "no-eviction-subset"}])


# --- the reference's planner cases, in the NVSwitch form ---


def test_planner_unblocks_with_minimal_moves():
    plan = plan_moves(_blocked_fleet(), target_block=4, max_moves=8)
    assert plan["blocked_hosts"] == ["host-a"]
    assert len(plan["moves"]) == 1  # one eviction suffices; no sweep
    (move,) = plan["moves"]
    assert (move["source_node"], move["dest_node"], move["chips"]) == ("host-a", "host-b", 2)
    # the index is 0 on NVSwitch: it never rises, and cannot fall
    assert plan["fragmentation_after"] == plan["fragmentation_before"] == 0.0
    (group,) = plan["groups"]
    assert group["predicted_fragmentation_index"] <= plan["fragmentation_before"]


def test_planner_picks_cheapest_eviction():
    def cost(tenant, n_gpus):
        return 0.5 if tenant == "ns/t2" else 50.0

    plan = plan_moves(_blocked_fleet(), target_block=4, max_moves=8, cost_fn=cost)
    (move,) = plan["moves"]
    assert (move["pod"], move["est_cost_s"], move["source_indices"]) == ("t2", 0.5, [6, 7])


def test_planner_respects_disruption_budgets():
    plan = plan_moves(_blocked_fleet(), target_block=4, max_moves=8, tenant_move_budget=0)
    assert plan["moves"] == []
    assert any(s["reason"] == "tenant-budget" for s in plan["skipped"])
    plan = plan_moves(_blocked_fleet(), target_block=4, max_moves=0)
    assert plan["moves"] == []
    assert any(s["reason"] == "move-budget" for s in plan["skipped"])


def test_planner_stale_snapshot_refuses_not_thrashes():
    """The negative control: a stale snapshot, or one of unknown age, is
    refused with the reference's cause, status and message."""
    now = time.time()
    for at in (now - 120.0, None):
        seen = {}
        for side, (plan_fn, error, *_rest) in SIDES.items():
            with pytest.raises(error) as exc:
                plan_fn(_blocked_fleet(), target_block=4, max_moves=8, snapshot_at=at,
                        max_snapshot_age_s=60.0, now=now)
            seen[side] = (exc.value.cause, exc.value.status, str(exc.value))
        assert seen["port"] == seen["reference"]
        assert seen["port"][:2] == ("stale-snapshot", 409)


def test_planner_noop_on_healthy_fleet():
    nodes = {"host-a": _entry(range(8)), "host-b": _entry(range(8))}
    plan = plan_moves(nodes, target_block=4, max_moves=8)
    assert plan["moves"] == [] and plan["blocked_hosts"] == []
    assert plan["fragmentation_after"] == plan["fragmentation_before"]
    assert plan == ref_plan_moves(nodes, target_block=4, max_moves=8)


def test_planner_refuses_partial_groups_without_destination():
    """A lone blocked host with nowhere to put its tenant: the group is
    dropped whole."""
    nodes = {"host-a": _blocked_fleet()["host-a"]}
    plan = plan_moves(nodes, target_block=4, max_moves=8)
    assert plan["moves"] == []
    assert any(s["reason"] == "no-destination" for s in plan["skipped"])


def test_planner_refuses_quarantined_destinations():
    """The health plane's quarantined hosts are non-destinations, and a
    group with nowhere else to go is dropped whole (the reference's
    ``tests/test_health.py`` case, in the NVSwitch form)."""
    nodes = _blocked_fleet()
    assert plan_moves(nodes, target_block=4, max_moves=8)["moves"]
    plan = plan_moves(nodes, target_block=4, max_moves=8, non_destinations={"host-b"})
    assert plan["moves"] == []
    assert any(s["reason"] == "no-destination" for s in plan["skipped"])


# --- the controller's gates ---


class _BurningSlo:
    def evaluate(self):
        return {"burn_threshold": 2.0, "objectives": [
            {"name": "tenant-migration-downtime", "breached": False, "burn_fast": 3.5},
            {"name": "slice-feasibility", "burn_fast": 0.0}]}


class _BrokenSlo:
    def evaluate(self):
        raise RuntimeError("slo store corrupt")


class _DeadApi:
    def ok(self):
        return False

    def state(self):
        return "down"


def _refusals(call, **kw) -> dict:
    """`call(controller)` on both packages' controllers built with `kw`:
    side -> (cause, status, message)."""
    seen = {}
    for side, (_, _, controller, refused, _) in SIDES.items():
        ctrl = controller(None, None, None, None, cfg=_cfg(side), **kw)
        with pytest.raises(refused) as exc:
            call(ctrl)
        seen[side] = (exc.value.cause, exc.value.status, str(exc.value))
    assert seen["port"] == seen["reference"]
    return seen["port"]


def test_controller_refuses_to_plan_while_slo_burns():
    cause, status, message = _refusals(lambda c: c.plan(), slo=_BurningSlo())
    assert (cause, status) == ("slo-burn", 503) and "tenant-migration-downtime" in message
    assert _refusals(lambda c: c.run(), slo=_BurningSlo())[0] == "slo-burn"


def test_controller_fails_closed_when_slo_engine_breaks():
    assert _refusals(lambda c: c.plan(), slo=_BrokenSlo())[:2] == ("slo-burn", 503)


def test_controller_parks_under_degraded_api():
    assert _refusals(lambda c: c.plan(), apihealth=_DeadApi())[:2] == ("api-degraded", 503)


def test_controller_run_requires_an_adopted_plan():
    assert _refusals(lambda c: c.run())[:2] == ("no-plan", 409)


def test_controller_refuses_stale_adopted_plan():
    """The controller's half of the negative control: a plan older than the
    bound is dropped at run time, so no retry loop can act on it."""
    ctrl = DefragController(None, None, None, None, cfg=Config())
    ctrl._plan = {"id": "dfp-old", "created_at": time.time() - 3600.0, "moves": [],
                  "groups": []}
    with pytest.raises(DefragRefused) as exc:
        ctrl.run()
    assert exc.value.cause == "stale-snapshot"
    assert ctrl._plan is None
    with pytest.raises(DefragRefused) as exc:
        ctrl.run()
    assert exc.value.cause == "no-plan"


class _FlatCapacity:
    def payload(self, max_age_s=None):
        return {"fleet": {"fragmentation_index": 0.0}}

    def record_recovery(self, **kw):
        pass


def test_run_executes_host_disjoint_groups_concurrently():
    """Two groups with disjoint hosts share a batch: the fast one finishes
    while the slow one is held (event ordering only, no sleeps)."""
    ctrl = DefragController(None, None, _FlatCapacity(), None,
                            cfg=dataclasses.replace(Config(), defrag_group_fanout=2))
    slow_entered, release_slow, fast_done = (threading.Event() for _ in range(3))

    def fake_move(run, move):
        if move["source_node"] == "slow-host":
            slow_entered.set()
            assert release_slow.wait(timeout=10.0)
        else:
            fast_done.set()
        return "succeeded"

    ctrl._execute_move = fake_move
    move = {"namespace": "ns", "pod": "t", "chips": 2, "est_cost_s": 1.0}
    ctrl._plan = {"id": "dfp-fanout", "created_at": time.time(),
                  "groups": [{"node": "slow-host"}, {"node": "fast-host"}],
                  "moves": [{**move, "group": "slow-host", "source_node": "slow-host",
                             "dest_node": "spare-a"},
                            {**move, "group": "fast-host", "source_node": "fast-host",
                             "dest_node": "spare-b"}]}
    ctrl.run()
    try:
        assert slow_entered.wait(timeout=10.0)
        assert fast_done.wait(timeout=10.0)
        assert not release_slow.is_set()
    finally:
        release_slow.set()
    thread = ctrl._run_thread
    if thread is not None:
        thread.join(timeout=10.0)
    last = ctrl.payload()["history"][-1]
    assert (last["status"], last["plan_id"]) == ("completed", "dfp-fanout")
    serial = DefragController(None, None, _FlatCapacity(), None,
                              cfg=dataclasses.replace(Config(), defrag_group_fanout=1))
    assert [len(b) for b in serial._disjoint_batches(
        [{"node": "slow-host"}, {"node": "fast-host"}], {})] == [1, 1]
    overlap = {"fast-host": [{"source_node": "fast-host", "dest_node": "slow-host"}]}
    assert [len(b) for b in ctrl._disjoint_batches(
        [{"node": "slow-host"}, {"node": "fast-host"}], overlap)] == [1, 1]


# --- the executor's batches (the reference's tests/test_vchip.py cases) ---


def _batches(groups, by_group, fanout):
    """Both packages' batches of the same groups; the port's, once equal."""
    out = {side: SIDES[side][2]._disjoint_batches(
        types.SimpleNamespace(cfg=types.SimpleNamespace(defrag_group_fanout=fanout)),
        groups, by_group) for side in SIDES}
    assert out["port"] == out["reference"]
    return out["port"]


def _group(node, moves):
    return {"node": node}, [{"source_node": s, "dest_node": d} for s, d in moves]


def test_disjoint_batches_caps_at_fanout():
    groups, by_group = [], {}
    for name in ("g1", "g2", "g3"):
        g, mv = _group(name, [(name, f"{name}-dst")])
        groups.append(g)
        by_group[name] = mv
    batches = _batches(groups, by_group, fanout=2)
    assert [len(b) for b in batches] == [2, 1]
    assert [g["node"] for b in batches for g in b] == ["g1", "g2", "g3"]


def test_disjoint_batches_splits_on_shared_host():
    g1, mv1 = _group("g1", [("g1", "shared-dst")])
    g2, mv2 = _group("g2", [("g2", "shared-dst")])
    g3, mv3 = _group("g3", [("g3", "g3-dst")])
    batches = _batches([g1, g2, g3], {"g1": mv1, "g2": mv2, "g3": mv3}, fanout=4)
    assert [[g["node"] for g in b] for b in batches] == [["g1"], ["g2", "g3"]]


def test_disjoint_batches_serial_under_fanout_one():
    g1, mv1 = _group("g1", [])
    g2, mv2 = _group("g2", [])
    assert [len(b) for b in _batches([g1, g2], {"g1": mv1, "g2": mv2}, fanout=1)] == [1, 1]


# --- a whole run on stubs: the records and the recovery stamp ---


class _StubKube:
    """The standby on host-b, Running and annotated; tenants without owner
    annotations (they move under their own names)."""

    def __init__(self):
        self.standby = {"metadata": {"name": "standby", "namespace": "ns",
                                     "annotations": {"tpumounter.io/defrag-dest": "ready"}},
                        "spec": {"nodeName": "host-b"}, "status": {"phase": "Running"}}

    def list_pods(self, namespace, label_selector=None):
        return [self.standby]

    def get_pod(self, namespace, name):
        return {"metadata": {"name": name, "namespace": namespace, "annotations": {}},
                "spec": {"nodeName": "host-a"}, "status": {"phase": "Running"}}


class _StubMigrations:
    """A migration that succeeds at once and moves the tenant's GPUs in the
    fleet stub (pinned input 4's move: host-a's 4-5 to host-b's 0-1)."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.begun = []

    def list_migrations(self):
        return []

    def begin(self, ns, pod, dest_ns, dest_pod, checkpoint=False):
        self.begun.append((ns, pod, dest_ns, dest_pod, checkpoint))
        return {"id": "mig-1", "trace_id": "t" * 32}

    def wait(self, mid, timeout_s=60.0):
        self.fleet.nodes = PINNED_AFTER
        return {"outcome": "succeeded", "downtime_s": 0.25, "checkpointed": True,
                "phase_durations_s": {"drain": 0.1, "remount": 0.15}}


PINNED_AFTER = {
    "host-a": _entry([2, 3, 4, 5], {6: "ns/t2", 7: "ns/t2"}, warm=[0, 1]),
    "host-b": {"capacity": {"free": [], "warm": [], "fenced": [],
                            "held": {0: "ns/t1", 1: "ns/t1",
                                     **{i: "ns/f" for i in range(2, 8)}}}}}


def _masked(record: dict) -> tuple:
    details = {k: v for k, v in (record.get("details") or {}).items() if k != "plan_id"}
    return record["operation"], record.get("actor"), record.get("outcome"), details


def test_a_completed_run_stamps_the_references_records():
    """Pinned input 4, where the two planners agree, through both packages'
    controllers over the same stubs: the same plan, one checkpointed
    migration to the standby, and the same defrag.plan, defrag.run and
    capacity.recovered records (plan ids masked): the port's caller of
    ``record_recovery``."""
    ref_plane = ref_capacity._PLANE
    seen = {}
    try:
        for side, (_, _, controller, _, _) in SIDES.items():
            fleet = _FleetStub(PINNED["agree"][0])
            plane = (ref_capacity if side == "reference" else capacity).CapacityPlane(
                fleet, cfg=_cfg(side))
            migrations = _StubMigrations(fleet)
            ctrl = controller(_StubKube(), migrations, plane, fleet, cfg=_cfg(side))
            plan = ctrl.plan(target_block=4)
            ctrl.run(plan["id"], wait=True)
            run = ctrl.payload()["history"][-1]
            trail = REF_AUDIT.snapshot() if side == "reference" else AUDIT.snapshot()
            records = [_masked(r) for r in trail if r["operation"].startswith(
                ("defrag.", "capacity.recovered"))]
            plan = {k: v for k, v in plan.items() if k not in ("id", "created_at", "snapshot_at")}
            seen[side] = (plan, migrations.begun, run["status"],
                          [{k: v for k, v in m.items()} for m in run["moves"]], records)
    finally:
        ref_capacity.register_plane(ref_plane)
    assert seen["port"] == seen["reference"]
    plan, begun, status, moves, records = seen["port"]
    assert begun == [("ns", "t1", "ns", "standby", True)] and status == "completed"
    assert [r[0] for r in records] == ["defrag.plan", "capacity.recovered", "defrag.run"]
    assert records[1][3]["moves"] == 1 and records[1][3]["fleet_largest_block"] == 4


# --- the config knobs ---

CONFIG_KEYS = {
    "defrag_enabled": ("TPUMOUNTER_DEFRAG", False),
    "defrag_interval_s": ("DEFRAG_INTERVAL_S", 300.0),
    "defrag_max_moves": ("DEFRAG_MAX_MOVES", 8),
    "defrag_tenant_move_budget": ("DEFRAG_TENANT_MOVE_BUDGET", 1),
    "defrag_snapshot_max_age_s": ("DEFRAG_SNAPSHOT_MAX_AGE_S", 60.0),
    "defrag_target_block": ("DEFRAG_TARGET_BLOCK", 4),
    "defrag_group_fanout": ("DEFRAG_GROUP_FANOUT", 2),
}


@pytest.mark.parametrize("key", list(CONFIG_KEYS))
def test_the_config_keys_are_the_references(key, monkeypatch):
    """The seven knobs, with the reference's defaults and environment names;
    the default block of 4 is nvidia-h100-80gb-4's GPUs on one host."""
    env, default = CONFIG_KEYS[key]
    assert getattr(Config(), key) == getattr(RefConfig(), key) == default
    monkeypatch.setenv(env, "true" if isinstance(default, bool) else "3")
    assert getattr(Config(), key) == getattr(ref_config.Config(), key) != default


# --- the routes on a bare master ---


@pytest.fixture()
def apps():
    """Both packages' masters over their fake API servers; yields {side:
    handle(method, path, body, auth=True) -> (status, text, headers)}."""
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


def _undated(payload):
    if isinstance(payload, dict):
        return {k: _undated(v) for k, v in payload.items()
                if k not in ("at", "created_at", "id", "snapshot_at")}
    if isinstance(payload, list):
        return [_undated(v) for v in payload]
    return payload


def test_defrag_routes(apps):
    """GET /defrag, a run with nothing adopted (409), a no-op plan over an
    empty fleet, its run, the pause and a malformed override (400): the
    reference's codes and bodies."""
    _, handle = apps
    codes = []
    for method, path, body in (("GET", "/defrag", b""), ("POST", "/defrag/run", b"{}"),
                               ("POST", "/defrag/plan", b"{}"),
                               ("POST", "/defrag/pause", b""),
                               ("POST", "/defrag/plan", b'{"target_block": 0}'),
                               ("POST", "/defrag/plan", b"[1]"),
                               ("POST", "/defrag/run", b"not json")):
        got = {side: handle[side](method, path, body) for side in SIDES}
        assert got["port"][0] == got["reference"][0], (method, path, body)
        texts = [got[side][1] for side in SIDES]
        if got["port"][0] == 200:
            texts = [_undated(json.loads(t)) for t in texts]
        assert texts[0] == texts[1], (method, path, body)
        codes.append(got["port"][0])
    assert codes == [200, 409, 200, 200, 400, 400, 400]
    status, text, _ = handle["port"]("GET", "/defrag")
    payload = json.loads(text)
    assert status == 200 and payload["gates"]["api_ok"] is True and payload["run"] is None
    status, text, _ = handle["port"]("POST", "/defrag/plan", b"{}")
    plan = json.loads(text)
    assert status == 200 and plan["moves"] == [] and plan["id"].startswith("dfp-")
    assert handle["port"]("POST", "/defrag/run", b'{"plan_id": "dfp-other"}')[:2] == (
        409, f"adopted plan is {plan['id']}, not dfp-other\n")
    status, _, _ = handle["port"]("POST", "/defrag/run", json.dumps(
        {"plan_id": plan["id"]}).encode())
    assert status == 200


def test_defrag_mutate_routes_require_auth(apps):
    _, handle = apps
    for path in ("/defrag/plan", "/defrag/run", "/defrag/pause"):
        assert [handle[side]("POST", path, b"{}", auth=False)[0] for side in SIDES] \
            == [401, 401], path
    assert [handle[side]("GET", "/defrag", auth=False)[0] for side in SIDES] == [401, 401]


def test_defrag_route_parks_with_retry_after(apps):
    built, handle = apps
    for app in built.values():
        app.defrag.slo = _BurningSlo()
    got = {side: handle[side]("POST", "/defrag/plan", b"{}") for side in SIDES}
    assert got["port"][:2] == got["reference"][:2]
    status, text, headers = got["port"]
    assert status == 503 and "refusing to add migration disruption" in text
    assert headers["Retry-After"] == got["reference"][2]["Retry-After"] == "300"


# --- the chaos harness: a blocked host recovered, invariant 18 ---


@pytest.mark.parametrize("seed", SEEDS)
def test_defrag_chaos(tmp_path, seed):
    """Invariant 18 across the fixed seeds: the run completed, its one move
    succeeded onto the standby's lowest-indexed free GPUs (the ones the plan
    named), its window is trace-attributed, the index never rose; books ==
    mounts == ledger == capacity. The reference's run on the same seed ends
    alike: completed, one succeeded move, three barriers."""
    from gpumounter_tpu.testing.chaos import ChaosHarness as RefHarness
    with RefHarness(str(tmp_path / "reference"), seed) as h:
        ref_run = h.run_defrag_scenario()
        h.check_invariants()
    with ChaosHarness(str(tmp_path / "port"), seed, nodes=dict(DEFRAG_NODES)) as h:
        run = h.run_defrag_scenario()
        h.check_invariants()
        (move,) = run["moves"]
        held = h.held_gpus()[("default", "df-standby")]
        index_of = {d.uuid: d.index for d in h.cluster.node(NODE_B).backend.list_devices()}
        assert sorted(index_of[u] for u in held) == [3, 4]
    assert run["status"] == ref_run["status"] == "completed"
    assert [m["outcome"] for m in run["moves"]] == [m["outcome"] for m in ref_run["moves"]] \
        == ["succeeded"]
    assert len(run["barriers"]) == len(ref_run["barriers"]) == 3
    assert (move["pod"], move["source_node"], move["dest_node"], move["dest_pod"]) == \
        ("df-t1", NODE_A, NODE_B, "default/df-standby")
    # no tenant acks the checkpoint on either side: both drain without it
    assert move["checkpointed"] == ref_run["moves"][0]["checkpointed"]


def test_admissible_after_defrag_verdict_flips(tmp_path):
    """nvidia-h100-80gb-4 reads admissible-after-defrag on /capacity before
    the run (NODE_A held back by its warm holders) and admissible after it."""
    from conftest import AUTH_HEADER
    with ChaosHarness(str(tmp_path), 7, nodes=dict(DEFRAG_NODES)) as h:
        h.seed_fragmentation()
        before = h.app.capacity.payload(max_age_s=0.0)["feasibility"]
        assert before["nvidia-h100-80gb-4"]["verdict"] == "admissible-after-defrag"
        assert before["nvidia-h100-80gb-4"]["blocking_hosts"] == [NODE_A]
        plan = h.app.defrag.plan(target_block=4)
        assert plan["blocked_hosts"] == [NODE_A] and len(plan["moves"]) == 1
        h.app.defrag.run(plan["id"], wait=True)
        run = h.app.defrag.payload()["history"][-1]
        assert run["status"] == "completed"
        h.defrag_runs.append(run)
        status, _, body, _ = h.app.handle("GET", "/capacity", b"", dict(AUTH_HEADER))
        assert status == 200
        after = json.loads(body)["feasibility"]
        assert after["nvidia-h100-80gb-4"]["verdict"] == "admissible"
        recovered = AUDIT.query(operation="capacity.recovered")
        assert len(recovered) == 1 and recovered[0]["details"]["moves"] == 1
        # the run's trace: its span, its group's, and the move's migration
        from gpumounter_tpu_torch.obs import trace
        names = {sp["name"] for sp in trace.TRACER.ring.spans_for(run["trace_id"])}
        assert {"defrag.run", "defrag.group"} <= names
        assert any(n.startswith("migrate.") for n in names), names
        h.check_invariants()


def test_defrag_run_failpoint_fails_closed_then_redrives(tmp_path):
    """The armed ``defrag.run`` failpoint: the run dies at its top, lands in
    the history as failed with the plan consumed, and a new plan re-drives
    the recovery to completion."""
    with ChaosHarness(str(tmp_path), 7, nodes=dict(DEFRAG_NODES)) as h:
        h.seed_fragmentation()
        plan = h.app.defrag.plan(target_block=4)
        failpoints.arm("defrag.run", "1*error(chaos defrag abort)")
        h.app.defrag.run(plan["id"], wait=True)
        run = h.app.defrag.payload()["history"][-1]
        assert run["status"] == "failed" and "chaos defrag abort" in run["error"]
        assert run["moves"] == []
        assert h.app.defrag.payload()["plan"] is None
        plan2 = h.app.defrag.plan(target_block=4)
        assert plan2["id"] != plan["id"]
        h.app.defrag.run(plan2["id"], wait=True)
        run2 = h.app.defrag.payload()["history"][-1]
        assert run2["status"] == "completed"
        h.defrag_runs.append(run2)
        h.check_invariants()


@pytest.mark.parametrize("control", ["traces-lost", "move-rolled-back"])
def test_invariant_18_names_an_unattributed_or_failed_move(tmp_path, control):
    """Invariant 18's negative controls (its monotone clause cannot fire on
    NVSwitch): a run whose move's trace no longer assembles, and a run whose
    move rolled back (the remount failed), are violations, with the seed."""
    with ChaosHarness(str(tmp_path), 7, nodes=dict(DEFRAG_NODES)) as h:
        if control == "traces-lost":
            h.run_defrag_scenario()
            assert h.drop_defrag_traces() > 0
            want = "does not assemble"
        else:
            h.seed_fragmentation()
            plan = h.app.defrag.plan(target_block=4)
            with failpoints.armed({"migrate.phase.remount": "1*error(chaos remount)"}):
                h.app.defrag.run(plan["id"], wait=True)
            run = h.app.defrag.payload()["history"][-1]
            assert run["status"] == "failed-move"
            h.defrag_runs.append(run)
            h.converge()
            want = "ended 'rolled-back'"
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
    assert want in str(err.value) and "seed=7" in str(err.value)
