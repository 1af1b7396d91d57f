"""The fractional shares (``gpumounter_tpu_torch/vchip/``) against the
reference's (``gpumounter_tpu/vchip/``): ``tests/test_vchip.py`` ported,
each case run on both packages with the same inputs and compared.

The seven CLI cases run on the port's CLI in ``tests/test_torch_cli.py``.
Left out, as CHANGES.md counts them: the four ``placement.defrag_aware_block`` cases (the port
leaves ``allocator/placement.py`` out: on NVSwitch no free GPU is a better
pick) and the three ``disjoint_batches`` cases (``DefragController``,
ROADMAP 7l2). The three V2DeviceController cases run on the port's fake map
kernel (``testing/bpf.py``), as both controllers' O(1) re-grant.
"""

from __future__ import annotations

import contextlib
import json
import os

import pytest
from conftest import AUTH_HEADER
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.device.tpu import TpuDevice
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFakeKube
from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu.obs import capacity as ref_capacity
from gpumounter_tpu.vchip import packer as ref_packer
from gpumounter_tpu.vchip import shares as ref_shares
from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.master import app as port_app
from gpumounter_tpu_torch.obs import capacity
from gpumounter_tpu_torch.testing.bpf import FakeBpf
from gpumounter_tpu_torch.vchip import packer, shares

#: (shares, packer, capacity, a config of changes)
SIDES = {
    "reference": (ref_shares, ref_packer, ref_capacity, lambda **kw: RefConfig().replace(**kw)),
    "port": (shares, packer, capacity, lambda **kw: Config(**kw)),
}


def _share(mod, ns="default", pod="p", chip="chip-0", node="node-a", weight=50, budget=0,
           profile="balanced"):
    return mod.Share(namespace=ns, pod=pod, chip_uuid=chip, node=node, weight=weight,
                     rate_budget=budget, profile=profile, created_at=1.0)


def _both(fn):
    """fn(side) on both sides; the port's result, asserted equal to the
    reference's."""
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["reference"]
    return got["port"]


def _unstamped(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k != "at"}


# --- the books ---


def test_the_books_shape_and_payload():
    def run(side):
        mod, _, _, cfg = SIDES[side]
        reg = mod.ShareRegistry(cfg=cfg())
        reg.add(_share(mod, pod="prefill", weight=60, profile="prefill"))
        reg.add(_share(mod, pod="decode", weight=40, budget=64, profile="decode"))
        reg.add(_share(mod, pod="decode", chip="chip-1", weight=40, profile="decode"))
        return reg.books(), reg.chip_load("chip-0"), _unstamped(reg.payload())

    books, load, payload = _both(run)
    assert books == {"default/prefill": {"chip-0": (60, 0)},
                     "default/decode": {"chip-0": (40, 64), "chip-1": (40, 0)}}
    assert load == 100 and payload["schema"] == shares.SHARES_SCHEMA == "tpumounter-shares/1"
    assert payload["totals"] == {"shares": 3, "chips": 2, "shared_chips": 1}
    chip0 = payload["chips"]["chip-0"]
    assert (chip0["tenants"], chip0["load"], chip0["headroom"], chip0["profiles"]) == \
        (2, 100, 0, ["decode", "prefill"])
    assert payload["chips"]["chip-1"]["headroom"] == 60


def test_a_rebooking_is_a_regrant_in_place():
    def run(side):
        mod, _, _, cfg = SIDES[side]
        reg = mod.ShareRegistry(cfg=cfg(vchip_max_shares=1))
        reg.add(_share(mod, weight=50))
        updated = reg.add(_share(mod, weight=70, budget=16))
        with pytest.raises(mod.ShareLimitError):
            reg.add(_share(mod, chip="chip-9"))
        return updated.weight, reg.books()

    assert _both(run) == (70, {"default/p": {"chip-0": (70, 16)}})


def test_remove_tenant_returns_its_shares():
    def run(side):
        mod, _, _, cfg = SIDES[side]
        reg = mod.ShareRegistry(cfg=cfg())
        for kw in ({"chip": "chip-0"}, {"chip": "chip-1"}, {"pod": "other", "chip": "chip-0"}):
            reg.add(_share(mod, **kw))
        victims = reg.remove_tenant("default", "p")
        return (sorted(s.chip_uuid for s in victims), reg.by_tenant("default", "p"),
                set(reg.shared_chips()), reg.remove_tenant("default", "p"))

    assert _both(run) == (["chip-0", "chip-1"], [], {"chip-0"}, [])


def test_the_series_move_as_the_references():
    from gpumounter_tpu.utils.metrics import REGISTRY as REF_REGISTRY
    from gpumounter_tpu_torch.utils.metrics import REGISTRY

    def run(side):
        mod, _, _, cfg = SIDES[side]
        reg_ = REF_REGISTRY if side == "reference" else REGISTRY
        before = {n: reg_.find(n).get() for n in ("tpumounter_vchip_share_admits_total",
                                                  "tpumounter_vchip_share_releases_total")}
        reg = mod.ShareRegistry(cfg=cfg())
        reg.add(_share(mod, pod="a"))
        reg.add(_share(mod, pod="b"))
        reg.add(_share(mod, pod="b", chip="chip-1"))
        reg.remove_tenant("default", "b")
        return ({n: reg_.find(n).get() - v for n, v in before.items()},
                reg_.find("tpumounter_vchip_shares_active").get(),
                reg_.find("tpumounter_vchip_shared_chips").get())

    assert _both(run) == ({"tpumounter_vchip_share_admits_total": 3.0,
                           "tpumounter_vchip_share_releases_total": 2.0}, 1.0, 0.0)


# --- the packer ---


def _packer(side, capacity_=100, max_shares=1024):
    mod, pmod, _, cfg = SIDES[side]
    conf = cfg(vchip_weight_capacity=capacity_, vchip_max_shares=max_shares)
    reg = mod.ShareRegistry(cfg=conf)
    return pmod.SharePacker(reg, cfg=conf), reg


def _uuids(booked):
    return [s.chip_uuid for s in booked]


#: (books before: (pod, chip, weight, profile)...), the admission's
#: arguments, the GPUs it books
PACKS = {
    "a complementary tenant over a free GPU": (
        [("decode", "shared-0", 40, "decode")],
        dict(pod="prefill", profile="prefill", chips=1, weight=50,
             inventory={"free-0": "node-b"}), ["shared-0"]),
    "the most loaded complementary GPU first": (
        [("d1", "loose", 30, "decode"), ("d2", "tight", 60, "decode")],
        dict(pod="prefill", profile="prefill", chips=1, weight=30), ["tight"]),
    "the same profile last among the shared": (
        [("p1", "same", 30, "prefill"), ("d1", "compl", 30, "decode")],
        dict(pod="p2", profile="prefill", chips=2, weight=30), ["compl", "same"]),
    "a blocked host's free GPU last": (
        [], dict(pod="p", profile="balanced", chips=1, weight=50,
                 inventory={"a-blocked": "node-x", "b-clear": "node-y"},
                 blocked_hosts={"node-x"}), ["b-clear"]),
    "a blocked host before a refusal": (
        [("p", "b-clear", 50, "balanced")],
        dict(pod="q", profile="balanced", chips=1, weight=60,
             inventory={"a-blocked": "node-x", "b-clear": "node-y"},
             blocked_hosts={"node-x"}), ["a-blocked"]),
}


@pytest.mark.parametrize("case", list(PACKS))
def test_the_packer_ranks_as_the_references(case):
    books, kwargs, want = PACKS[case]

    def run(side):
        p, reg = _packer(side)
        mod = SIDES[side][0]
        for pod, chip, weight, profile in books:
            reg.add(_share(mod, pod=pod, chip=chip, weight=weight, profile=profile))
        kw = dict(kwargs)
        booked = p.admit("default", kw.pop("pod"), kw.pop("profile"), kw.pop("chips"),
                         kw.pop("weight"), **kw)
        return _uuids(booked), {c: reg.chip_load(c) for c in sorted(reg.shared_chips())}

    assert _both(run)[0] == want
    assert packer.COMPLEMENTS == ref_packer.COMPLEMENTS == {"prefill": "decode",
                                                            "decode": "prefill"}


def test_a_refusal_books_nothing():
    def run(side):
        p, reg = _packer(side)
        mod = SIDES[side][0]
        reg.add(_share(mod, pod="d1", chip="full", weight=80, profile="decode"))
        with pytest.raises(SIDES[side][1].PackRefused) as err:
            p.admit("default", "prefill", "prefill", 1, 30)
        return str(err.value), reg.by_tenant("default", "prefill")

    message, left = _both(run)
    assert left == [] and "need 1 chip(s)" in message


def test_a_refusal_midway_books_nothing():
    def run(side):
        p, reg = _packer(side, max_shares=1)
        with pytest.raises(SIDES[side][0].ShareLimitError):
            p.admit("default", "p", "balanced", 2, 50, inventory={"c-0": "n", "c-1": "n"})
        return reg.books()

    assert _both(run) == {}


@pytest.mark.parametrize("kwargs", [{"chips": 0}, {"weight": 0}, {"weight": 101},
                                    {"rate_budget": -1}], ids=str)
def test_the_arguments_are_checked(kwargs):
    def run(side):
        p, _ = _packer(side)
        args = {"chips": 1, "weight": 50, "rate_budget": 0, **kwargs}
        with pytest.raises(SIDES[side][1].PackRefused) as err:
            p.admit("default", "p", "balanced", args["chips"], args["weight"],
                    rate_budget=args["rate_budget"])
        return str(err.value)

    _both(run)


# --- the capacity plane's fractional view ---


class _FleetStub:
    def __init__(self, nodes):
        self.nodes = nodes

    def payload(self, max_age_s=None):
        return {"at": 1.0, "nodes": self.nodes}


def _snap(free, total=8):
    return {"schema": capacity.CAPACITY_SCHEMA, "total": total, "free": sorted(free),
            "warm": [], "fenced": [], "held": {}, "warm_ready": 0, "ownership_known": True}


#: (the books: (pod, chip, node, weight)...), the fleet's nodes, the view
VIEWS = {
    "headroom on a reporting host": (
        [("p", "chip-a", "node-live", 60), ("q", "chip-a", "node-live", 20)],
        {"node-live": {"capacity": _snap([0, 1])}},
        {"capacity_unknown": False, "chips": 1, "shares": 2, "booked_weight": 80,
         "share_headroom": 20, "effective_free_weight": 220, "unknown_chips": 0,
         "weight_capacity": 100}),
    "a host not reporting is unknown, never free": (
        [("p", "chip-a", "node-gone", 10), ("p", "chip-b", "node-legacy", 10)],
        {"node-legacy": {}},
        {"capacity_unknown": True, "chips": 0, "shares": 2, "booked_weight": 0,
         "share_headroom": 0, "effective_free_weight": 0, "unknown_chips": 2,
         "weight_capacity": 100}),
}


@pytest.mark.parametrize("case", list(VIEWS))
def test_the_shares_view_is_the_references(case):
    books, nodes, want = VIEWS[case]

    def run(side):
        mod, _, cmod, cfg = SIDES[side]
        conf = cfg(vchip_weight_capacity=100)
        reg = mod.ShareRegistry(cfg=conf)
        for pod, chip, node, weight in books:
            reg.add(_share(mod, pod=pod, chip=chip, node=node, weight=weight))
        return cmod.CapacityPlane(_FleetStub(nodes), cfg=conf, shares=reg).payload()["shares"]

    assert _both(run) == want


def test_the_shares_view_is_absent_without_books():
    assert _both(lambda side: "shares" in SIDES[side][2].CapacityPlane(
        _FleetStub({}), cfg=SIDES[side][3]()).payload()) is False


def test_blocked_hosts_are_the_union_of_the_after_defrag_verdicts(monkeypatch):
    table = {
        "a": {"verdict": "admissible-after-defrag", "blocking_hosts": ["node-a", "node-b"]},
        "b": {"verdict": "admissible-after-defrag", "blocking_hosts": ["node-b", "node-c"]},
        "c": {"verdict": "admissible", "blocking_hosts": ["node-ignored"]},
    }

    def run(side):
        plane = SIDES[side][2].CapacityPlane(_FleetStub({}), cfg=SIDES[side][3]())
        monkeypatch.setattr(plane, "_feasibility", lambda hosts, fleet: table)
        return plane.blocked_hosts()

    assert _both(run) == frozenset({"node-a", "node-b", "node-c"})


def test_blocked_hosts_degrade_to_the_empty_set():
    class _Broken:
        def payload(self, max_age_s=None):
            raise RuntimeError("fleet down")

    assert _both(lambda side: SIDES[side][2].CapacityPlane(
        _Broken(), cfg=SIDES[side][3]()).blocked_hosts()) == frozenset()


# --- the /shares routes ---


def _close(app) -> None:
    """The port's app closes; the reference's has no close, and its
    registry's watch stops."""
    if isinstance(app, port_app.MasterApp):
        app.close()
    else:
        app.registry.stop()


@pytest.fixture
def apps():
    made = {"reference": ref_app.MasterApp(RefFakeKube(), cfg=RefConfig()),
            "port": port_app.MasterApp(FakeKubeClient(), cfg=Config())}
    yield made
    for app in made.values():
        _close(app)


def _admit_body(pod="prefill", profile="prefill", weight=60, chips=1, budget=0,
                inventory=None):
    return json.dumps({"namespace": "default", "pod": pod, "profile": profile, "chips": chips,
                       "weight": weight, "rate_budget": budget,
                       "inventory": inventory or {"chip-0": "node-a"}}).encode()


def _call(app, method, path, body=b""):
    status, _, text, _ = app.handle(method, path, body, dict(AUTH_HEADER))
    return status, text


def _shares_flow(app) -> list:
    out = []
    status, text = _call(app, "GET", "/shares")
    out.append((status, json.loads(text)["totals"]))
    status, text = _call(app, "POST", "/shares", _admit_body())
    out.append((status, [s["chip_uuid"] for s in json.loads(text)["admitted"]]))
    # the decode tenant joins the prefill's GPU although a free one is offered
    status, text = _call(app, "POST", "/shares", _admit_body(
        pod="decode", profile="decode", weight=40, budget=64, inventory={"chip-free": "node-a"}))
    out.append((status, json.loads(text)["admitted"][0]["chip_uuid"]))
    status, text = _call(app, "GET", "/shares")
    payload = json.loads(text)
    out.append((status, payload["totals"], payload["chips"]["chip-0"]["load"]))
    status, text = _call(app, "POST", "/shares", _admit_body(pod="third", weight=30,
                                                               inventory={}))
    out.append((status, json.loads(_call(app, "GET", "/shares")[1])["totals"]["shares"]))
    status, text = _call(app, "DELETE", "/shares/default/decode")
    out.append((status, [s["chip_uuid"] for s in json.loads(text)["released"]]))
    out.append(_call(app, "DELETE", "/shares/default/decode")[0])
    return out


def test_the_shares_routes_admit_colocate_refuse_and_release_as_the_references(apps):
    got = {side: _shares_flow(app) for side, app in apps.items()}
    assert got["port"] == got["reference"] == [
        (200, {"shares": 0, "chips": 0, "shared_chips": 0}), (200, ["chip-0"]),
        (200, "chip-0"), (200, {"shares": 2, "chips": 1, "shared_chips": 1}, 100),
        (409, 2), (200, ["chip-0"]), 404]


MALFORMED = [b"{not json", b"[1, 2]", json.dumps({"pod": "p"}).encode(),
             json.dumps({"namespace": "d", "pod": "p", "inventory": {"c": 3}}).encode(),
             json.dumps({"namespace": "d", "pod": "p", "weight": "heavy"}).encode()]


def test_a_malformed_admission_is_400_as_the_references(apps):
    got = {side: [_call(app, "POST", "/shares", body) for body in MALFORMED]
           for side, app in apps.items()}
    assert got["port"] == got["reference"]
    assert [status for status, _ in got["port"]] == [400] * len(MALFORMED)


def test_the_admission_is_503_with_vchip_off_and_the_books_stay_readable():
    made = {"reference": ref_app.MasterApp(RefFakeKube(),
                                           cfg=RefConfig().replace(vchip_enabled=False)),
            "port": port_app.MasterApp(FakeKubeClient(), cfg=Config(vchip_enabled=False))}
    try:
        got = {side: (_call(app, "POST", "/shares", _admit_body()),
                      _call(app, "GET", "/shares")[0]) for side, app in made.items()}
    finally:
        for app in made.values():
            _close(app)
    assert got["port"] == got["reference"]
    assert got["port"][0][0] == 503 and got["port"][1] == 200


def test_the_admission_passes_the_planes_hosts(apps, monkeypatch):
    """The route hands the packer the capacity plane's blocked hosts and the
    health plane's quarantined and probation ones, as the reference's."""
    seen = {}
    for side, app in apps.items():
        monkeypatch.setattr(app.capacity, "blocked_hosts", lambda max_age_s=None: {"node-b"})
        monkeypatch.setattr(app.health, "excluded_hosts", lambda: frozenset({"node-q"}))
        monkeypatch.setattr(app.health, "probation_hosts", lambda: frozenset({"node-p"}))
        status, text = _call(app, "POST", "/shares", _admit_body(
            pod="t", chips=3, inventory={"g-q": "node-q", "g-b": "node-b", "g-p": "node-p",
                                         "g-c": "node-c"}))
        seen[side] = (status, [s["chip_uuid"] for s in json.loads(text)["admitted"]])
    assert seen["port"] == seen["reference"] == (200, ["g-c", "g-p", "g-b"])


# --- V2DeviceController: the O(1) re-grant over the policy map ---


@pytest.fixture
def map_kernels(tmp_path):
    """Both controllers over the fake map kernel, runc's program attached to
    each cgroup first."""
    out = {}
    with contextlib.ExitStack() as stack:
        for side, mod in (("reference", ref_ebpf), ("port", ebpf)):
            kernel = stack.enter_context(FakeBpf(maps=True).installed(mod))
            cg = tmp_path / side / "cgroup"
            cg.mkdir(parents=True)
            cg_key = os.path.realpath(str(cg))
            kernel.preattach(cg_key, 7)
            out[side] = (mod, kernel, cg_key, str(tmp_path / side))
        yield out


def _dev(side, index):
    if side == "reference":
        return TpuDevice(index=index, device_path=f"/dev/accel{index}", major=250, minor=index,
                         uuid=f"chip{index}")
    return GpuDevice(index=index, device_path=f"/dev/nvidia{index}", major=250, minor=index,
                     uuid=f"chip{index}")


def _controller(mod, root):
    return mod.V2DeviceController(pin_dir=os.path.join(root, "bpffs"),
                                  state_dir=os.path.join(root, "state"))


def _pmap(kernel, ctl, cg_key):
    return kernel.map_objs[kernel.fd2map[ctl._state[cg_key].policy_fd]]


def test_a_warm_regrant_is_a_map_write_only(map_kernels):
    """One program swap at the first grant; every re-grant, re-weight and
    revoke after it is a policy-map write."""
    def run(side):
        mod, kernel, cg_key, root = map_kernels[side]
        ctl = _controller(mod, root)
        steps = []

        def counters():
            return mod.PROGRAM_SWAPS.get(), mod.MAP_GRANTS.get()

        s0, g0 = counters()
        dev0, dev1 = _dev(side, 0), _dev(side, 1)
        key0 = mod.telemetry_key(250, 0)
        ctl.grant(cg_key, dev0, tenant="default/prefill", policy={"chip0": (60, 128)})
        pmap = _pmap(kernel, ctl, cg_key)
        steps.append((counters(), pmap[key0]))
        ctl.grant(cg_key, dev0, tenant="default/prefill", policy={"chip0": (40, 128)})
        steps.append((counters(), pmap[key0]))
        ctl.grant(cg_key, dev1, tenant="default/prefill")
        steps.append((counters(), pmap[mod.telemetry_key(250, 1)]))
        ctl.update_policy(cg_key, dev0, weight=75, tokens=32)
        steps.append((counters(), pmap[key0]))
        ctl.revoke(cg_key, dev0)
        steps.append((counters(), key0 in pmap, ctl.enumerate_policies()[cg_key]))
        ctl.close()
        return [(((s - s0), (g - g0)), *rest) for (s, g), *rest in steps]

    steps = _both(run)
    key1 = ebpf.telemetry_key(250, 1)
    assert [s[0][0] for s in steps] == [1.0] * 5  # one swap, at the first grant
    assert [s[0][1] for s in steps][:2] == [1.0, 2.0]
    assert steps[0][1] == ebpf.policy_value(60, 128) and steps[1][1] == ebpf.policy_value(40, 128)
    assert steps[2][1] == ebpf.policy_value(0, ebpf.POLICY_UNMETERED)
    assert steps[3][1] == ebpf.policy_value(75, 32)
    assert steps[4][1:] == (False, {key1: ebpf.policy_value(0, ebpf.POLICY_UNMETERED)})


def test_an_orphan_policy_entry_is_found_and_collected(map_kernels):
    def run(side):
        mod, kernel, cg_key, root = map_kernels[side]
        ctl = _controller(mod, root)
        ctl.grant(cg_key, _dev(side, 0), policy={"chip0": (50, 0)})
        before = ctl.orphan_policy_keys()
        stray = mod.telemetry_key(99, 99)
        _pmap(kernel, ctl, cg_key)[stray] = mod.policy_value(10, 10)
        found = ctl.orphan_policy_keys()
        collected = ctl.gc_policy_orphans()
        left = sorted(_pmap(kernel, ctl, cg_key))
        after = ctl.orphan_policy_keys()
        ctl.close()
        return before, {k == cg_key: v for k, v in found.items()}, collected, left, after

    before, found, collected, left, after = _both(run)
    assert (before, found, collected, after) == ({}, {True: [ebpf.telemetry_key(99, 99)]},
                                                 1, {})
    assert left == [ebpf.telemetry_key(250, 0)]


def test_the_policy_map_pin_survives_a_restart(map_kernels):
    """A restarted controller opens the pinned policy map (the same object
    the attached program reads) with no swap, and a re-grant after it is
    still a map write."""
    def run(side):
        mod, kernel, cg_key, root = map_kernels[side]
        dev, key = _dev(side, 0), mod.telemetry_key(250, 0)
        ctl_a = _controller(mod, root)
        ctl_a.grant(cg_key, dev, tenant="ns/pod", policy={"chip0": (60, 8)})
        live = _pmap(kernel, ctl_a, cg_key)
        pinned = any(p.endswith("-pmap") for p in os.listdir(os.path.join(root, "bpffs")))
        swaps0 = mod.PROGRAM_SWAPS.get()
        ctl_b = _controller(mod, root)
        restored = _pmap(kernel, ctl_b, cg_key) is live
        policies = {k == cg_key: v for k, v in ctl_b.enumerate_policies().items()}
        ctl_b.grant(cg_key, dev, tenant="ns/pod", policy={"chip0": (45, 8)})
        out = (pinned, restored, policies, mod.PROGRAM_SWAPS.get() - swaps0, live[key])
        ctl_b.close()
        ctl_a.close()
        return out

    assert _both(run) == (True, True, {True: {ebpf.telemetry_key(250, 0):
                                              ebpf.policy_value(60, 8)}},
                          0.0, ebpf.policy_value(45, 8))
