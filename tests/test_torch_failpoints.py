"""The failpoint registry, on the reference's and on the port's.

Each case of ``tests/test_failpoints.py`` is a script of calls (arm, arm a
spec, fire, read a value, count the hits, list what is armed) run on both
packages' registries; what each call returned or raised must be equal. The
probabilistic kinds draw from each registry's own RNG: under the same
``seed(n)`` the two make the same draws. Then the port's site registry, the
counterpart of the reference's tpulint rule ``failpoint-registry``: every
``fire``/``value`` site name in ``gpumounter_tpu_torch/`` is declared once in
``faults/registry.py``, every declared name has a site, and the port's
tests arm every declared name.
"""

from __future__ import annotations

import ast
import pathlib
import re
import time
import types

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu_torch.faults import failpoints, registry

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"reference": ref_failpoints, "port": failpoints}


def _run(fp, script) -> list:
    """Each call's answer: its value, or (type name, message) of what it
    raised."""
    out = []
    for op, *args in script:
        try:
            if op == "sleep-fire":  # a delay: the call sleeps at least its argument
                t0 = time.monotonic()
                fp.fire(args[0])
                out.append(time.monotonic() - t0 >= args[1])
                continue
            out.append(getattr(fp, op)(*args))
        except Exception as exc:  # noqa: BLE001 — the raise is the answer
            out.append((type(exc).__name__, str(exc)))
    return out


SCRIPTS = {
    "nothing armed": [("fire", "never.armed"), ("value", "never.armed", 41), ("active",)],
    "error(boom)": [("arm", "site.a", "error(boom)"), ("fire", "site.a"), ("fire", "site.a"),
                    ("hits", "site.a")],
    "2*error(x)": [("arm", "site.b", "2*error(x)"), ("fire", "site.b"), ("fire", "site.b"),
                   ("fire", "site.b"), ("is_armed", "site.b")],
    "1*pass->1*error(second)": [("arm", "site.seq", "1*pass->1*error(second)"),
                                ("fire", "site.seq"), ("fire", "site.seq"),
                                ("fire", "site.seq"), ("is_armed", "site.seq")],
    "1*crash(dead)": [("arm", "site.crash", "1*crash(dead)"), ("fire", "site.crash"),
                      ("fire", "site.crash")],
    "1*unavailable(gone)": [("arm", "site.drop", "1*unavailable(gone)"),
                            ("fire", "site.drop")],
    "1*delay(0.05)": [("arm", "site.slow", "1*delay(0.05)"), ("sleep-fire", "site.slow", 0.05),
                      ("is_armed", "site.slow")],
    "return(409)": [("arm", "site.v", "return(409)"), ("value", "site.v", None),
                    ("fire", "site.v")],
    "return(true)": [("arm", "site.flag", "return(true)"), ("value", "site.flag", False)],
    "return(hello)": [("arm", "site.str", "return(hello)"), ("value", "site.str", "")],
    "1*error(reset by peer *)": [("arm", "site.star", "1*error(reset by peer *)"),
                                 ("fire", "site.star")],
    "return(a*b)": [("arm", "site.star2", "return(a*b)"), ("value", "site.star2", "")],
    "1*error(kapow) at a value site": [("arm", "site.v2", "1*error(kapow)"),
                                       ("value", "site.v2", "default"),
                                       ("value", "site.v2", "default")],
    "a=1*error(x); b=delay(0.0), c=return(1)": [
        ("arm_spec", "a=1*error(x); b=delay(0.0), c=return(1)"), ("active",),
        ("arm", "b", "off"), ("active",), ("fire", "a"), ("value", "c", 0)],
    "j=return([409, 500]);k=error(a, b)": [("arm_spec", "j=return([409, 500]);k=error(a, b)"),
                                           ("value", "j", None), ("fire", "k")],
    "zap(1)": [("arm", "x", "zap(1)")],
    "0*error(y)": [("arm", "x", "0*error(y)")],
    "missing-equals-sign": [("arm_spec", "missing-equals-sign")],
    "delay(not-a-number)": [("arm", "x", "delay(not-a-number)")],
    "error(a)->1*error(b)": [("arm", "x", "error(a)->1*error(b)")],
    "pdelay([2, 1])": [("arm", "x", "pdelay([2, 1])")],
    "pdelay(x)": [("arm", "x", "pdelay(x)")],
    "pdrop(1.5)": [("arm", "x", "pdrop(1.5)")],
    "1*unavailable(x)->pdrop(0)": [("arm", "x", "1*unavailable(x)->pdrop(0)"), ("fire", "x"),
                                   ("fire", "x"), ("active",), ("disarm", "x"),
                                   ("is_armed", "x")],
}


@pytest.mark.parametrize("spec", list(SCRIPTS))
def test_a_spec_acts_as_the_references(spec):
    got = {}
    for name, fp in PACKAGES.items():
        fp.disarm_all()
        got[name] = _run(fp, SCRIPTS[spec])
        fp.disarm_all()
    assert got["port"] == got["reference"]


def test_armed_restores_the_state_before_it_on_both():
    def script(fp):
        fp.arm("outer", "3*error(kept)")
        with fp.armed({"inner": "1*error(tmp)", "outer": "1*pass"}):
            fp.fire("outer")
            inner = _run(fp, [("fire", "inner")])
        return inner + [fp.is_armed("inner")] + _run(fp, [("fire", "outer")] * 4)

    got = {name: script(fp) for name, fp in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][-1] is None  # the three kept errors spent, then nothing


def test_the_environment_arms_both(monkeypatch):
    for fp in PACKAGES.values():
        monkeypatch.setenv(fp.ENV_VAR, "env.site=1*error(from-env)")
        fp._arm_from_env()
    assert failpoints.ENV_VAR == ref_failpoints.ENV_VAR == "TPUMOUNTER_FAILPOINTS"
    assert _run(failpoints, [("fire", "env.site")]) == _run(ref_failpoints, [("fire", "env.site")])


@pytest.mark.parametrize("seed", [0, 7, 1337])
@pytest.mark.parametrize("action", ["pdrop(0.5)", "pdelay([0.3, 0])"])
def test_seeded_draws_are_the_references(seed, action):
    """The same seed gives the same coin flips: which calls dropped, and
    which delays fired (each one a fire counted)."""
    from gpumounter_tpu.faults.failpoints import FAILPOINT_FIRES as REF_FIRES
    from gpumounter_tpu_torch.faults.failpoints import FAILPOINT_FIRES
    got = {}
    for (name, fp), counter in zip(PACKAGES.items(), (REF_FIRES, FAILPOINT_FIRES), strict=True):
        fp.arm("gray", action)
        fp.seed(seed)
        draws = []
        for _ in range(200):
            before = counter.get(name="gray")
            dropped = _run(fp, [("fire", "gray")])[0] is not None
            draws.append((dropped, counter.get(name="gray") - before))
        got[name] = draws
        fp.disarm_all()
    assert got["port"] == got["reference"]
    assert 0 < sum(fired for _, fired in got["port"]) < 200  # some fired, not all


def test_nothing_armed_is_one_flag():
    """With nothing armed a site reads one attribute and returns."""
    assert failpoints._REGISTRY._any_armed is False
    failpoints.arm("site", "1*pass")
    assert failpoints._REGISTRY._any_armed is True
    failpoints.fire("site")
    assert failpoints._REGISTRY._any_armed is False


# --- the port's site registry ---

def _sites() -> list[tuple[str, str, bool]]:
    """(file, name or f-string prefix, dynamic) of every failpoints.fire /
    failpoints.value call in the port's package."""
    out = []
    for path in sorted((REPO / "gpumounter_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("fire", "value")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "failpoints" and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                out.append((path.name, arg.value, False))
            else:
                assert isinstance(arg, ast.JoinedStr), (path, ast.dump(arg))
                out.append((path.name, arg.values[0].value, True))
    return out


def test_every_site_is_declared_once_and_every_declared_name_has_a_site():
    sites = _sites()
    names = {name for _, name, dynamic in sites if not dynamic}
    assert names == set(registry.FAILPOINTS)
    for file, prefix, dynamic in sites:
        if dynamic:
            assert any(prefix.startswith(p) for p in registry.DYNAMIC_PREFIXES), (file, prefix)
    keys = [k.value for k in ast.parse((REPO / "gpumounter_tpu_torch/faults/registry.py")
                                       .read_text()).body[2].value.keys]
    assert len(keys) == len(set(keys)) == len(registry.FAILPOINTS)
    # the reference's names, every one, but worker.addtpu.rollback.skip
    from gpumounter_tpu.faults import registry as ref_registry
    renamed = {n.replace("addtpu", "addgpu") for n in ref_registry.FAILPOINTS}
    assert set(registry.FAILPOINTS) == renamed


def test_every_declared_name_is_armed_by_a_test():
    """A name counts as armed where a port test (or the chaos pool its tests
    draw from) names it in an arm call, an armed({...}) schedule or a spec
    string; a dynamic family where a test arms one of its members."""
    texts = [p.read_text() for p in sorted((REPO / "tests").glob("test_torch_*.py"))]
    texts.append((REPO / "gpumounter_tpu_torch/testing/chaos.py").read_text())
    blob = "\n".join(texts)
    for name in registry.FAILPOINTS:
        assert re.search(rf'"{re.escape(name)}(=|")', blob), name
    members = {"k8s.": r"(create_pod|delete_pod|patch_pod)(\.status)?",
               "migrate.phase.": "(quiesce|checkpoint|drain|remount|resume|verify)"}
    assert set(members) == set(registry.DYNAMIC_PREFIXES)
    for prefix in registry.DYNAMIC_PREFIXES:
        assert re.search(rf'"{re.escape(prefix)}{members[prefix]}(=|")', blob), prefix


def test_the_pool_refill_site_fires_as_the_references():
    """``pool.refill`` fires before each refill's create, with the node: an
    armed error fails the pass on both pools, creates nothing, counts one
    failure and one hit, and backs the node off."""
    import dataclasses

    from gpumounter_tpu.allocator import pool as ref_pool
    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu.k8s.fake import FakeKubeClient as RefFake
    from gpumounter_tpu_torch.allocator import pool
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.k8s.fake import FakeKubeClient

    seen = {}
    for name, fp, mod, kube, cfg in (
            ("reference", ref_failpoints, ref_pool, RefFake(),
             RefConfig().replace(warm_pool_size=2, warm_pool_retry_s=30.0)),
            ("port", failpoints, pool, FakeKubeClient(),
             dataclasses.replace(Config(), warm_pool_size=2, warm_pool_retry_s=30.0))):
        mod.WARM_POOL_REFILL_FAILURES._values.clear()
        warm = mod.WarmPodPool(kube, cfg=cfg, refill_async=False)
        warm.ensure_node("n1")
        with fp.armed({"pool.refill": "error(refill boom)"}):
            added = warm.refill_once()
            hits = fp.hits("pool.refill")
        seen[name] = (added, kube.create_calls, hits,
                      mod.WARM_POOL_REFILL_FAILURES._values.get((), 0.0), warm.refill_once())
    assert seen["port"] == seen["reference"] == (0, 0, 1, 1.0, 0)


def test_the_defrag_run_site_fires_as_the_references():
    """``defrag.run`` fires at the top of a run, with the plan's id: an armed
    error fails the run on both controllers before its first barrier, with
    the reference's status and error, and consumes the plan."""
    import dataclasses
    import time

    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu.defrag import DefragController as RefController
    from gpumounter_tpu_torch.config import Config
    from gpumounter_tpu_torch.defrag import DefragController

    class _Capacity:
        def payload(self, max_age_s=None):
            return {"fleet": {"fragmentation_index": 0.0}}

    seen = {}
    for name, fp, ctrl in (
            ("reference", ref_failpoints, RefController(None, None, _Capacity(), None,
                                                        cfg=RefConfig())),
            ("port", failpoints, DefragController(None, None, _Capacity(), None,
                                                  cfg=dataclasses.replace(Config())))):
        ctrl._plan = {"id": "dfp-1", "created_at": time.time(), "moves": [], "groups": []}
        with fp.armed({"defrag.run": "1*error(defrag abort)"}):
            ctrl.run("dfp-1", wait=True)
            hits = fp.hits("defrag.run")
        run = ctrl.payload()["history"][-1]
        seen[name] = (hits, run["status"], run["error"], [b["label"] for b in run["barriers"]],
                      ctrl.payload()["plan"])
    assert seen["port"] == seen["reference"]
    assert seen["port"][:2] == (1, "failed") and seen["port"][3] == ["end"]


def test_the_autoscale_pass_site_fires_as_the_references():
    """``autoscale.pass`` fires at the top of a pass, after the gates: an
    armed error aborts the pass on both controllers before the fleet is
    read, and the one-shot action leaves the next pass clean."""
    import dataclasses

    from gpumounter_tpu.autoscale import AutoscaleController as RefController
    from gpumounter_tpu.config import Config as RefConfig
    from gpumounter_tpu_torch.autoscale import AutoscaleController
    from gpumounter_tpu_torch.config import Config

    class _Fleet:
        def __init__(self):
            self.reads = 0

        def payload(self, max_age_s=None):
            self.reads += 1
            return {"nodes": {}}

    class _Elastic:
        store = types.SimpleNamespace(list=lambda: [])

    seen = {}
    for name, fp, cls, cfg in (("reference", ref_failpoints, RefController, RefConfig()),
                               ("port", failpoints, AutoscaleController,
                                dataclasses.replace(Config()))):
        fleet = _Fleet()
        ctrl = cls(_Elastic(), None, fleet, cfg=cfg)
        with fp.armed({"autoscale.pass": "1*error(autoscale abort)"}):
            with pytest.raises(Exception, match="autoscale abort"):
                ctrl.evaluate_once()
            hits, reads = fp.hits("autoscale.pass"), fleet.reads
            status = ctrl.evaluate_once()["status"]
        seen[name] = (hits, reads, status, fleet.reads)
    assert seen["port"] == seen["reference"] == (1, 0, "completed", 1)
