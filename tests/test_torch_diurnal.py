"""The diurnal fleet sim of the port against the reference's.

``gpumounter_tpu_torch/testing/diurnal.py`` is the NVSwitch form of
``gpumounter_tpu/testing/diurnal.py``. On seed 20260807, with the six
tenants of the reference bench's ``prod/web`` and ``prod/asia`` templates
(``bench_diurnal.py:101-107``, scale 1), 288 ticks of a 144-tick day, each
package's own sim and controller:

  * the arrivals are bit-equal, and so is the static leg;
  * on a fleet with room for every grow (40 hosts, no ballast) the decisions
    fired are the reference's, tick by tick;
  * with ``seed_ballast(12)`` the 28 ballast hosts keep GPUs 0 and 3 free: a
    block of 2 on NVSwitch, two ICI singletons on the reference's board. The
    verdicts and decisions of that leg are pinned beside the reference's
    (ROADMAP §3, "The NVSwitch autoscaler");
  * the NVSwitch seams: one block a host, the allocator's best-fit host,
    the defragmenter fake's empty plan, and no fragmentation wave and no
    compaction, which have nothing to do on NVSwitch.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import pytest

from gpumounter_tpu.autoscale import AutoscaleController as RefController
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.testing import diurnal as ref_diurnal
from gpumounter_tpu_torch.autoscale import AutoscaleController
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.testing import diurnal

SEED = 20260807
TICKS = 288
DAY_TICKS = 144
TICK_S = 60.0
PER_CHIP_RPS = 1.0
SLO_WAIT_S = 180.0
#: the reference bench's first two templates: (stem, base, amplitude, phase, count)
TEMPLATES = [("prod/web", 10.0, 30.0, 0.00, 3), ("prod/asia", 8.0, 26.0, 0.50, 3)]

SIDES = {"reference": (ref_diurnal, RefController, RefConfig),
         "port": (diurnal, AutoscaleController, Config)}


def _profiles(mod) -> list:
    return [mod.TenantProfile(name=f"{stem}-{k:02d}", base_rps=base * (1.0 + 0.06 * k),
                              amp_rps=amp * (1.0 + 0.04 * k), phase=phase + 0.015 * k)
            for stem, base, amp, phase, count in TEMPLATES for k in range(count)]


def _leg(side: str, n_nodes: int, ballast: int | None = None) -> dict:
    """The autoscaled leg of the bench's loop, with no chaos: a tick, a pass,
    a reconcile. Returns the decisions fired (tick, tenant, action, from,
    to), the grows' verdicts, the sim's counters, the defrag plans asked
    for and, on the reference's side, its fake's runs and the GPUs they
    relocated (the port's fake never runs: no plan of it has a move)."""
    mod, controller, config = SIDES[side]
    profiles = _profiles(mod)
    arrivals = mod.build_arrivals(profiles, TICKS, DAY_TICKS, TICK_S, SEED)
    sim = mod.DiurnalSim(profiles, n_nodes=n_nodes, seed=SEED, tick_s=TICK_S,
                         per_chip_rps=PER_CHIP_RPS, day_ticks=DAY_TICKS,
                         warm_ttl_ticks=max(10, DAY_TICKS // 6), slo_wait_s=SLO_WAIT_S)
    if ballast is not None:
        sim.seed_ballast(ballast)
    sim.reconcile()
    ctrl = controller(cfg=config(), **sim.controller_kwargs())
    fired, verdicts, reasons = [], Counter(), Counter()
    for i in range(TICKS):
        sim.tick(arrivals)
        record = ctrl.evaluate_once()
        assert record["status"] == "completed"
        for d in record["decisions"]:
            if "feasibility" in d:
                verdicts[d["feasibility"]["verdict"]] += 1
            if d["action"] in ("grow", "shrink"):
                fired.append((i, d["tenant"], d["action"], d["from_chips"], d["to_chips"]))
            else:
                reasons[d["reason"]] += 1
        sim.reconcile()
    return {"fired": fired, "verdicts": dict(verdicts), "reasons": dict(reasons),
            "counters": {k: getattr(sim, k) for k in (
                "warm_attaches", "scatter_allocs", "unplaced")},
            "defrag": sim.defrag.requests,
            "compaction": ((sim.defrag.runs, sim.compaction_moves) if side == "reference"
                           else None),
            "utilization": sim.utilization(), "breaches": sim.breach_ticks()}


def test_the_arrivals_and_the_static_leg_are_the_references():
    """Bit-equal arrivals and the same static leg at peak and at mean."""
    out = {}
    for side, (mod, _, _) in SIDES.items():
        profiles = _profiles(mod)
        arrivals = mod.build_arrivals(profiles, TICKS, DAY_TICKS, TICK_S, SEED)
        legs = [mod.run_static_leg(profiles, arrivals,
                                   {p.name: max(p.min_chips, int(-(-how(p) // PER_CHIP_RPS)))
                                    for p in profiles},
                                   TICKS, TICK_S, PER_CHIP_RPS, SLO_WAIT_S)
                for how in (lambda p: p.peak_rps(DAY_TICKS), lambda p: p.mean_rps(DAY_TICKS))]
        out[side] = (arrivals, legs, [(p.name, p.peak_rps(DAY_TICKS), p.mean_rps(DAY_TICKS))
                                      for p in profiles])
    assert out["port"] == out["reference"]
    assert len(out["port"][0]) == 6 and all(len(v) == TICKS for v in out["port"][0].values())
    assert out["port"][1][0]["utilization"] < out["port"][1][1]["utilization"]


def test_an_uncontended_leg_fires_the_references_decisions_tick_by_tick():
    """40 hosts, no ballast: every grow is admissible on either form, so the
    two sims, each driven by its own controller, fire the same decisions on
    the same ticks (230: 146 grows, each admissible) and end with the same
    counters and breaches."""
    ref, port = _leg("reference", 40), _leg("port", 40)
    assert port["fired"] == ref["fired"]
    assert len(port["fired"]) == 230
    assert port["verdicts"] == ref["verdicts"] == {"admissible": sum(
        1 for f in port["fired"] if f[2] == "grow")}
    for key in ("reasons", "counters", "defrag", "utilization", "breaches"):
        assert port[key] == ref[key], key
    assert ref["compaction"] == (0, 0)


def test_the_ballast_leg_in_the_nvswitch_form():
    """Pinned (ROADMAP §3): 40 hosts, 12 open and 28 of ballast that leave
    GPUs 0 and 3 free, 152 GPUs for six tenants whose peaks want more. Both
    fleets run out: the grows wait for a defrag where free and warm GPUs
    together reach the grow, and find nothing otherwise. The reference's
    board makes each ballast pair two singletons, so its free GPUs alone
    defer a grow of 2 there and its fake's plan has moves (one run, 168
    GPUs repacked); on NVSwitch the pair is a block, only a shrink's warm
    GPUs defer, and the fake's plan never has a move. Reference: 85
    decisions, verdicts admissible 63, after-defrag 390, infeasible 160;
    port: 87 decisions, 64, 388 and 160."""
    ref, port = _leg("reference", 40, ballast=12), _leg("port", 40, ballast=12)
    assert ref["verdicts"] == {"admissible": 63, "admissible-after-defrag": 390,
                               "infeasible": 160}
    assert (len(ref["fired"]), ref["defrag"], ref["compaction"]) == (85, 390, (1, 168))
    assert port["verdicts"] == {"admissible": 64, "admissible-after-defrag": 388,
                                "infeasible": 160}
    assert (len(port["fired"]), port["defrag"], port["compaction"]) == (87, 388, None)
    assert port["counters"]["unplaced"] == ref["counters"]["unplaced"] == 0


def test_the_nvswitch_seams():
    """One block a host; the allocator's best-fit host; the defragmenter
    fake's plan has no moves, and the port's sim has no compaction and no
    fragmentation wave, where the reference's wave claims 6 GPUs of each
    free host and leaves 2 singletons."""
    assert diurnal._components({0, 3, 5}) == [{0, 3, 5}] and diurnal._components(set()) == []
    assert ref_diurnal._components({0, 3, 5}) == [{0}, {3, 5}]
    profile = diurnal.TenantProfile(name="ns/t", base_rps=2.0, amp_rps=0.0, phase=0.0)
    sim = diurnal.DiurnalSim([profile], n_nodes=3, seed=SEED)
    sim.nodes["sim-0000"].held = {i: "x/x" for i in range(7)}          # free {7}
    sim.nodes["sim-0001"].held = {i: "x/x" for i in (1, 2, 4, 5, 6)}   # free {0, 3, 7}
    sim._allocate(sim.tenants["ns/t"], 2)
    assert sim.tenants["ns/t"].chips == {("sim-0001", 0), ("sim-0001", 3)}
    assert sim.defrag.plan()["moves"] == [] and sim.scatter_allocs == 0
    ref = ref_diurnal.DiurnalSim([ref_diurnal.TenantProfile(name="ns/t", base_rps=2.0,
                                                            amp_rps=0.0, phase=0.0)],
                                 n_nodes=4, seed=SEED)
    assert (ref.fragment_wave(), sum(len(n.free_set()) for n in ref.nodes.values())) == (24, 8)
    assert not any(hasattr(sim, name) for name in ("fragment_wave", "compact"))
    assert not hasattr(sim.defrag, "run")


@pytest.mark.parametrize("free", [(0, 3), (0, 3, 5, 6)])
def test_a_ballast_hosts_free_pair_is_one_block(free):
    """The ballast's pattern and the capacity plane's cases as the sim
    publishes them: one host's free GPUs read as one block by the port's
    controller, so a grow of their count is admissible; the reference
    defers it to a defrag."""
    held = {i: "ballast/b" for i in range(8) if i not in free}
    nodes = {"h": {"capacity": {"total": 8, "free": list(free), "held": held, "warm": [],
                                "fenced": []}}}
    verdicts = {}
    for side, (_, controller, config) in SIDES.items():
        ctrl = controller(None, None, None, cfg=config())
        verdicts[side] = ctrl._grow_feasibility(len(free), nodes)["verdict"]
    assert verdicts == {"reference": "admissible-after-defrag", "port": "admissible"}


def test_the_sims_intents_are_the_ports():
    """The sim's store holds the port's Intent, its initial provision the
    reference's."""
    sims = {side: mod.DiurnalSim(_profiles(mod), n_nodes=4, seed=SEED, day_ticks=DAY_TICKS)
            for side, (mod, _, _) in SIDES.items()}
    port = [(ns, pod, dataclasses.astuple(i)) for ns, pod, i in sims["port"].store.list()]
    ref = [(ns, pod, (i.desired_chips, i.min_chips, i.priority))
           for ns, pod, i in sims["reference"].store.list()]
    assert port == ref
    assert all(type(i).__module__ == "gpumounter_tpu_torch.elastic.intents"
               for _, _, i in sims["port"].store.list())
