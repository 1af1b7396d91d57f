"""The fleet's trace assembly (``gpumounter_tpu_torch/obs/assembly.py``)
against the reference's (``gpumounter_tpu/obs/assembly.py``).

Every span here is a dict with fixed start and duration stamps, made from a
seed: no span is timed and nothing sleeps. The same spans go into a private
tracer's ring and a private remote store of each package, and both
``assemble`` functions must give the same tree, waterfall, orphans and
missing worker halves; and the same phases, critical path and dominant
phase wherever the reference's phases sum to the wall. The port's always
do: a gap before a child that starts past its parent's window is charged
once, where the reference charges it twice (its smallest input is pinned
here). ``fleet_dominant_phase`` sums the assembled phases, the remote
stores dedupe and evict alike, and ``phase_of`` names every span the same.
"""

from __future__ import annotations

import numpy as np
import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.obs import assembly as ref_assembly
from gpumounter_tpu.obs import trace as ref_trace
from gpumounter_tpu_torch.obs import assembly, trace

SIDES = {"reference": (ref_assembly, ref_trace), "port": (assembly, trace)}
T0 = 1_760_000_000.0
NAMES = ("http.add", "http.remove", "http.batch_add", "http.admission", "proxy.batch",
         "k8s.get_pod", "rpc.AddGPU", "rpc.CollectTelemetry", "worker.AddGPU",
         "mount.slave_pod_schedule", "mount.cgroup_grant", "mount.mknod", "mount.verify",
         "mount.rollback", "unmount.device_remove", "unmount.cgroup_revoke", "migrate.drain",
         "slice.mount", "chaos.add 1 to p", "elastic.reconcile", "ledger.append", "odd")


def _tree(rng, tid: str, origin: float) -> list[dict]:
    """A seeded trace: an edge root, then spans under random earlier ones,
    each window inside or overlapping its parent's, with rpc spans ok or
    failed and some with their worker half."""
    spans = [{"trace_id": tid, "span_id": f"{tid[:8]}{0:08x}", "parent_id": "",
              "name": str(rng.choice(["http.add", "http.remove", "chaos.add 1 to p"])),
              "start": origin, "duration_s": float(rng.integers(20, 200)) / 1e3,
              "status": "ok"}]
    for i in range(1, int(rng.integers(3, 14))):
        parent = spans[int(rng.integers(len(spans)))]
        start = parent["start"] + float(rng.random()) * parent["duration_s"]
        name = str(rng.choice(NAMES))
        spans.append({"trace_id": tid, "span_id": f"{tid[:8]}{i:08x}",
                      "parent_id": parent["span_id"], "name": name, "start": round(start, 6),
                      "duration_s": round(float(rng.random()) * parent["duration_s"], 6),
                      "status": "error" if rng.random() < 0.15 else "ok"})
        if name.startswith("rpc.") and rng.random() < 0.6:
            rpc = spans[-1]
            spans.append({"trace_id": tid, "span_id": f"{tid[:8]}{i + 1000:08x}",
                          "parent_id": rpc["span_id"], "name": "worker.AddGPU",
                          "start": rpc["start"] + 0.001,
                          "duration_s": max(0.0, rpc["duration_s"] - 0.002), "status": "ok"})
    return spans


def _stores(seed: int, n_traces: int = 4):
    """Both packages' private tracer and remote store, holding the same
    seeded spans: some local, some remote (a node each), some in both, some
    dropped (orphaning their children)."""
    rng = np.random.default_rng(seed)
    out = {name: (t.Tracer(ring_capacity=4096), a.RemoteSpanStore(capacity=4096))
           for name, (a, t) in SIDES.items()}
    tids = []
    for k in range(n_traces):
        tid = f"{seed:04x}{k:04x}" + "0" * 24
        tids.append(tid)
        for span in _tree(rng, tid, T0 + k):
            where = float(rng.random())
            for tracer, store in out.values():
                if where < 0.05:
                    continue  # lost: its children are orphans
                if where < 0.55 or where > 0.9:
                    tracer.ring.export(dict(span))
                if where >= 0.55:
                    store.ingest(f"node-{int(span['start']) % 3}", [dict(span)])
    return out, tids


def _exact(tree: dict) -> bool:
    """Whether the phases sum to the wall: each phase is rounded to the µs."""
    return abs(sum(tree["phases"].values()) - tree["wall_ms"]) <= 1e-3 * len(tree["phases"])


ATTRIBUTION = ("phases", "critical_path", "dominant")


@pytest.mark.parametrize("seed", range(8))
def test_assemble_is_the_references_on_fixed_spans(seed):
    """The trees, waterfalls, orphans and missing halves are the
    reference's on every trace; the port's phases sum to the wall on every
    one, and are the reference's wherever the reference's do too (it
    charges twice a gap before a child past its parent's window)."""
    stores, tids = _stores(seed)
    for tid in tids + ["f" * 32]:
        got = {name: SIDES[name][0].assemble(tid, tracer=tracer, remote=store)
               for name, (tracer, store) in stores.items()}
        tree, ref_tree = got["port"], got["reference"]
        if tree is None:
            assert ref_tree is None and tid == "f" * 32
            continue
        assert {k: v for k, v in tree.items() if k not in ATTRIBUTION} == \
            {k: v for k, v in ref_tree.items() if k not in ATTRIBUTION}
        assert _exact(tree)
        if _exact(ref_tree):
            assert tree == ref_tree


def test_the_seeded_traces_hold_both_kinds():
    """The population above is not vacuous: it holds traces on which the
    reference's books are exact and traces on which they are not."""
    verdicts = set()
    for seed in range(8):
        stores, tids = _stores(seed)
        tracer, store = stores["reference"]
        for tid in tids:
            tree = ref_assembly.assemble(tid, tracer=tracer, remote=store)
            if tree is not None and tree["roots"]:
                verdicts.add(_exact(tree))
    assert verdicts == {True, False}


def test_a_child_past_its_parents_window_is_charged_once_where_the_reference_charges_it_twice():
    """The smallest input: an edge of 10 ms, its rpc span over 1-5 ms, and
    the worker's span at 6-8 ms (its clock ahead of the master's). The
    reference charges the rpc's 4 ms twice (a phase sum of 14 ms for a wall
    of 10); the port's phases sum to the wall."""
    tid = "cd" * 16
    spans = [{"trace_id": tid, "span_id": "e" * 16, "parent_id": "", "name": "http.add",
              "start": T0, "duration_s": 0.010, "status": "ok"},
             {"trace_id": tid, "span_id": "r" * 16, "parent_id": "e" * 16, "name": "rpc.AddGPU",
              "start": T0 + 0.001, "duration_s": 0.004, "status": "ok"},
             {"trace_id": tid, "span_id": "w" * 16, "parent_id": "r" * 16,
              "name": "worker.AddGPU", "start": T0 + 0.006, "duration_s": 0.002,
              "status": "ok"}]
    got = {}
    for name, (amod, tmod) in SIDES.items():
        tracer = tmod.Tracer()
        for span in spans:
            tracer.ring.export(dict(span))
        got[name] = amod.assemble(tid, tracer=tracer, remote=amod.RemoteSpanStore())
    assert got["reference"]["phases"] == {"edge": 6.0, "rpc": 8.0}
    assert got["port"]["phases"] == {"edge": 6.0, "rpc": 4.0}
    assert got["port"]["wall_ms"] == got["reference"]["wall_ms"] == 10.0
    assert got["port"]["complete"] and got["reference"]["complete"]


@pytest.mark.parametrize("seed", range(4))
def test_fleet_dominant_phase_sums_the_assembled_phases(seed):
    """The dominant phase of the newest traces is the sum of their
    assembled phases: the reference's wherever its books are exact."""
    stores, tids = _stores(seed, n_traces=6)
    got = {name: SIDES[name][0].fleet_dominant_phase(tracer=tracer, remote=store, limit=3)
           for name, (tracer, store) in stores.items()}
    tracer, store = stores["port"]
    newest = []
    for span in reversed(tracer.ring.snapshot()):
        if not span["parent_id"] and span["trace_id"] not in newest and any(
                span["name"].startswith(p) for p in assembly.MOUNT_EDGE_PREFIXES):
            newest.append(span["trace_id"])
    trees = [assembly.assemble(t, tracer=tracer, remote=store) for t in newest[:3]]
    acc: dict[str, float] = {}
    for tree in trees:
        for phase, ms in tree["phases"].items():
            acc[phase] = acc.get(phase, 0.0) + ms
    if not acc:
        assert got["port"] is None and got["reference"] is None
        return
    dominant = max(acc, key=lambda p: acc[p])
    assert got["port"] == {"phase": dominant, "ms": round(acc[dominant], 3),
                           "share": round(acc[dominant] / sum(acc.values()), 4),
                           "traces": len(trees)}
    ref_tracer, ref_store = stores["reference"]
    if all(_exact(ref_assembly.assemble(t, tracer=ref_tracer, remote=ref_store))
           for t in newest[:3]):
        assert got["port"] == got["reference"]


def test_an_add_with_its_worker_half_is_complete_and_sums_to_its_wall():
    """One hand-made add: an edge, its pod read, the rpc, the worker's spans
    federated from the node; the phases are the reference's and cover the
    edge's 100 ms exactly; without the worker half the rpc span is named."""
    tid = "ab" * 16
    local = [
        {"trace_id": tid, "span_id": "e" * 16, "parent_id": "", "name": "http.add",
         "start": T0, "duration_s": 0.1, "status": "ok"},
        {"trace_id": tid, "span_id": "k" * 16, "parent_id": "e" * 16, "name": "k8s.get_pod",
         "start": T0 + 0.001, "duration_s": 0.002, "status": "ok"},
        {"trace_id": tid, "span_id": "r" * 16, "parent_id": "e" * 16, "name": "rpc.AddGPU",
         "start": T0 + 0.004, "duration_s": 0.09, "status": "ok"}]
    remote = [
        {"trace_id": tid, "span_id": "w" * 16, "parent_id": "r" * 16, "name": "worker.AddGPU",
         "start": T0 + 0.005, "duration_s": 0.088, "status": "ok"},
        {"trace_id": tid, "span_id": "s" * 16, "parent_id": "w" * 16,
         "name": "mount.slave_pod_schedule", "start": T0 + 0.006, "duration_s": 0.004,
         "status": "ok"},
        {"trace_id": tid, "span_id": "m" * 16, "parent_id": "w" * 16, "name": "mount.mknod",
         "start": T0 + 0.011, "duration_s": 0.07, "status": "ok"}]
    got = {}
    for name, (amod, tmod) in SIDES.items():
        tracer, store = tmod.Tracer(), amod.RemoteSpanStore()
        for span in local:
            tracer.ring.export(dict(span))
        store.ingest("gpu-node-0", remote)
        got[name] = amod.assemble(tid, tracer=tracer, remote=store)
        half = amod.assemble(tid, tracer=tracer, remote=amod.RemoteSpanStore())
        assert not half["complete"] and half["missing_worker_halves"] == ["r" * 16]
    tree = got["port"]
    assert tree == got["reference"] and tree["complete"] and tree["nodes"] == ["gpu-node-0"]
    assert tree["phases"] == {"edge": 8.0, "k8s_api": 2.0, "rpc": 2.0, "worker": 14.0,
                              "slave_pod_schedule": 4.0, "mknod": 70.0}
    assert tree["dominant"] == {"phase": "mknod", "ms": 70.0, "share": 0.7}
    assert [(s["name"], s["depth"]) for s in tree["spans"]] == [
        ("http.add", 0), ("k8s.get_pod", 1), ("rpc.AddGPU", 1), ("worker.AddGPU", 2),
        ("mount.slave_pod_schedule", 3), ("mount.mknod", 3)]


@pytest.mark.parametrize("seed", range(3))
def test_the_remote_stores_dedupe_and_evict_alike(seed):
    rng = np.random.default_rng(seed)
    stores = {name: amod.RemoteSpanStore(capacity=16) for name, (amod, _) in SIDES.items()}
    counters = {name: (amod.REMOTE_SPANS_INGESTED, amod.REMOTE_SPAN_EVICTIONS)
                for name, (amod, _) in SIDES.items()}
    before = {name: (i.total(), e.total()) for name, (i, e) in counters.items()}
    new = {name: [] for name in stores}
    for _ in range(20):
        batch = [{"trace_id": f"{int(rng.integers(4)):032x}",
                  "span_id": f"{int(rng.integers(40)):016x}", "name": "worker.AddGPU"}
                 for _ in range(int(rng.integers(1, 6)))]
        batch += [{"span_id": "no-trace"}, "not a dict", {"trace_id": "t", "span_id": 7}]
        node = f"node-{int(rng.integers(2))}"
        for name, store in stores.items():
            new[name].append(store.ingest(node, [dict(s) if isinstance(s, dict) else s
                                                 for s in batch]))
    assert new["port"] == new["reference"]
    assert [s["span_id"] for s in stores["port"].snapshot()] == \
        [s["span_id"] for s in stores["reference"].snapshot()]
    assert len(stores["port"]) == len(stores["reference"]) <= 16
    grown = {name: (i.total() - before[name][0], e.total() - before[name][1])
             for name, (i, e) in counters.items()}
    assert grown["port"] == grown["reference"] and grown["port"][1] > 0
    assert assembly.RemoteSpanStore().ingest("n", "not a list") == 0


def test_phase_of_names_every_span_as_the_reference():
    assert assembly.PHASES == ref_assembly.PHASES
    for name in NAMES + ("", "worker.RemoveGPU", "rpc.RemoveGPU", "bulk.mount", "x.y.z"):
        assert assembly.phase_of(name) == ref_assembly.phase_of(name)
