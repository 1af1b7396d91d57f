"""The master's store: the port's ``store/k8s.py`` and ``store/watch.py``,
``elastic/intents.py`` and ``migrate/journal.py`` against the reference's.

The store contract of ``tests/test_store.py`` on both backends (list- and
watch-backed) of both packages (``tests/torch_store_sides.py``), with what
each case reads back compared: restart-resume parity (a fresh instance over
the same cluster reads what another wrote: intents, journals, the worker
registry, annotation stamps, the health state on its lease, the pool pods
by node). Then ``Intent`` and ``IntentStore`` (``tests/test_elastic_intents.py``
without its routes, CLI and work queue) and the journal's helpers. The
journals' times are masked.
"""

from __future__ import annotations

import json

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture
from torch_store_sides import SIDES, both, fresh, pod, worker_pod

from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu_torch.master import app as port_app

REGISTRIES = {"reference": ref_app.WorkerRegistry, "port": port_app.WorkerRegistry}


class Stores:
    """Fresh store instances of one backend over one fake cluster; each
    instance is a restarted master. Watch-backed ones wait for their LIST
    and are stopped at the end."""

    def __init__(self, side, backend: str):
        self.side, self.backend = side, backend
        self.kube = side.FakeKubeClient()
        self.cfg = fresh(side, store_watch_timeout_s=0.2)
        self.made = []

    def new(self):
        if self.backend == "kube":
            return self.side.store.KubeMasterStore(self.kube, self.cfg)
        store = self.side.store.WatchMasterStore(self.kube, self.cfg)
        assert store.wait_synced(10.0), "informer never primed"
        self.made.append(store)
        return store

    def settle(self, store) -> None:
        quiesce = getattr(store, "quiesce", None)
        if quiesce is not None:
            assert quiesce(5.0), "informer did not drain"

    def stop(self) -> None:
        for store in self.made:
            store.stop()


def _journal_view(journal: dict) -> dict:
    return {k: v for k, v in journal.items() if k not in ("created_at", "updated_at")}


def intent_roundtrip(s):
    Intent = s.side.Intent
    pod(s.kube, "tenant-a")
    pod(s.kube, "tenant-b", namespace="jobs")
    writer = s.new()
    writer.put_intent("default", "tenant-a", Intent(desired_chips=3, min_chips=1, priority=2))
    writer.put_intent("jobs", "tenant-b", Intent(desired_chips=1))
    reader = s.new()
    same = sorted(reader.list_intents()) == sorted(writer.list_intents())
    listed = sorted((ns, name, i.to_json()) for ns, name, i in reader.list_intents())
    got = reader.get_intent("default", "tenant-a").to_json()
    deleted = reader.delete_intent("default", "tenant-a")
    s.settle(writer)
    return same, listed, got, deleted, writer.get_intent("default", "tenant-a"), \
        reader.delete_intent("default", "tenant-a")


def intent_store_delegates(s):
    Intent = s.side.Intent
    pod(s.kube, "tenant-c")
    backend = s.new()
    store = s.side.intents.IntentStore(s.kube, s.cfg, backend=backend)
    store.put("default", "tenant-c", Intent(desired_chips=2))
    with pytest.raises(s.side.intents.IntentError):
        store.put("default", "tenant-c", Intent(desired_chips=65))
    with pytest.raises(s.side.errors.NotFoundError):
        store.get("default", "never-created")
    return backend.get_intent("default", "tenant-c").to_json(), \
        store.list() == backend.list_intents()


def journal_roundtrip(s):
    pod(s.kube, "src")
    pod(s.kube, "dst", node="node-1")
    writer = s.new()
    journal = s.side.journal.new_journal("mig-roundtrip", "default", "src", "default", "dst")
    journal["phase"] = "drain"
    journal["chips"] = ["gpu-a", "gpu-b"]
    writer.save_journal(journal)
    reader = s.new()
    scanned = [_journal_view(j) for j in reader.scan_journals()]
    listed = [_journal_view(j) for j in
              s.side.store.KubeMasterStore(s.kube, s.cfg).scan_journals()]
    with pytest.raises(s.side.errors.NotFoundError):
        writer.save_journal(s.side.journal.new_journal("mig-gone", "default", "vanished",
                                                       "default", "dst"))
    return scanned, scanned == listed


def registry_rebuilt(s):
    for i in range(5):
        worker_pod(s.kube, s.cfg, f"worker-{i}", f"node-{i}", ip=f"10.0.0.{i + 1}")
    pod(s.kube, "not-a-worker", namespace=s.cfg.worker_namespace, node="node-9")
    registry = REGISTRIES[s.side.kind]
    first = registry(s.kube, s.cfg, store=s.new())
    second = registry(s.kube, s.cfg, store=s.new())
    try:
        return first.registry_snapshot(), second.registry_snapshot()
    finally:
        first.stop()
        second.stop()


def stamp_write_and_clear(s):
    pod(s.kube, "stamped")
    store = s.new()
    store.stamp_annotation("default", "stamped", "tpumounter.io/migration-lock", '{"id":"m1"}')
    written = s.side.Pod(s.kube.get_pod("default", "stamped")).annotations
    store.stamp_annotation("default", "stamped", "tpumounter.io/migration-lock", None)
    cleared = s.side.Pod(s.kube.get_pod("default", "stamped")).annotations
    with pytest.raises(s.side.errors.NotFoundError):
        store.stamp_annotation("default", "missing", "a", "b")
    return written, cleared


def health_state_on_its_lease(s):
    store = s.new()
    before = store.load_health_state()
    store.save_health_state({"version": 1, "nodes": {"n1": {"state": "quarantined"}}})
    store.save_health_state({"version": 2, "nodes": {}})  # the CAS update
    lease = s.kube.get_lease(s.cfg.worker_namespace, "tpumounter-health")
    return before, s.new().load_health_state(), lease["metadata"]["resourceVersion"], \
        store.get_node("n1")


def pool_pods_by_node(s):
    pool = s.cfg.pool_namespace
    pod(s.kube, "slave-1", namespace=pool, node="n1")
    pod(s.kube, "slave-2", namespace=pool, node="n2")
    pod(s.kube, "tenant", node="n1")
    store = s.new()
    return {n: [p["metadata"]["name"] for p in store.list_pool_pods(n)] for n in ("n1", "n2",
                                                                              "n3")}


CASES = [intent_roundtrip, intent_store_delegates, journal_roundtrip, registry_rebuilt,
         stamp_write_and_clear, health_state_on_its_lease, pool_pods_by_node]


@pytest.mark.parametrize("backend", ["kube", "watch"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_the_store_contract_holds_as_the_references(case, backend):
    got = {}
    for name, side in SIDES.items():
        stores = Stores(side, backend)
        try:
            got[name] = case(stores)
        finally:
            stores.stop()
    assert got["port"] == got["reference"]
    if case is intent_roundtrip:
        assert got["port"][:3] == (True, [
            ("default", "tenant-a", {"desiredChips": 3, "minChips": 1, "priority": 2}),
            ("jobs", "tenant-b", {"desiredChips": 1, "minChips": 0, "priority": 0})],
            {"desiredChips": 3, "minChips": 1, "priority": 2})
        assert got["port"][3:] == (True, None, False)
    if case is registry_rebuilt:
        first, second = got["port"]
        assert first == second and set(first) == {f"node-{i}" for i in range(5)}
    if case is health_state_on_its_lease:
        assert got["port"] == (None, {"version": 2, "nodes": {}}, "2", None)
    if case is pool_pods_by_node:
        assert got["port"] == {"n1": ["slave-1"], "n2": ["slave-2"], "n3": []}


# --- Intent and IntentStore (tests/test_elastic_intents.py) ---

def test_an_intent_parses_and_validates_as_the_references():
    def case(side):
        Intent, IntentError = side.Intent, side.intents.IntentError
        intent = Intent(desired_chips=4, min_chips=2, priority=7)
        out = [intent.to_annotations(), intent.to_json(),
               side.Intent.from_annotations(intent.to_annotations()) == intent,
               Intent.from_annotations({}), Intent.from_json({"desiredChips": 2}).to_json()]
        for bad in (lambda: Intent(desired_chips=-1).validate(64),
                    lambda: Intent(desired_chips=65).validate(64),
                    lambda: Intent(desired_chips=2, min_chips=3).validate(64),
                    lambda: Intent.from_json({"desiredChips": "lots"}),
                    lambda: Intent.from_json({}), lambda: Intent.from_json([]),
                    lambda: Intent.from_annotations({side.intents.ANNOT_DESIRED: "many"})):
            with pytest.raises(IntentError) as exc:
                bad()
            out.append(str(exc.value))
        return out
    got = both(case)
    assert got["port"] == got["reference"]
    assert got["port"][0] == {"tpumounter.io/desired-chips": "4", "tpumounter.io/min-chips": "2",
                              "tpumounter.io/priority": "7"}


def test_the_intent_store_persists_as_annotations_as_the_references():
    def case(side):
        kube = side.FakeKubeClient()
        kube.create_pod("default", {"metadata": {"name": "trainer"},
                                    "spec": {"containers": [{"name": "main"}]}})
        store = side.intents.IntentStore(kube, side.Config())
        out = [store.get("default", "trainer")]
        store.put("default", "trainer", side.Intent(desired_chips=4, min_chips=2))
        out.append(side.Pod(kube.get_pod("default", "trainer")).annotations)
        restarted = side.intents.IntentStore(kube, side.Config())
        out += [restarted.get("default", "trainer").to_json(),
                [(ns, n, i.to_json()) for ns, n, i in restarted.list()],
                restarted.delete("default", "trainer"), restarted.get("default", "trainer"),
                restarted.delete("default", "trainer")]
        kube.patch_pod("default", "trainer", {"metadata": {"annotations": {
            side.intents.ANNOT_DESIRED: "many"}}})
        out.append(restarted.list())  # a malformed intent is skipped
        return out
    got = both(case)
    assert got["port"] == got["reference"]
    assert got["port"][4:] == [True, None, False, []]


# --- the journal's helpers ---

def test_the_journal_helpers_answer_as_the_references():
    def case(side):
        j = side.journal
        kube = side.FakeKubeClient()
        journal = j.new_journal("m1", "default", "src", "default", "dst")
        view = _journal_view(journal)
        raw = j.dump(dict(journal))
        pod(kube, "src", annotations={j.ANNOT_JOURNAL: raw})
        lock = json.dumps({"id": "m1", "role": "destination",
                           "source": {"namespace": "default", "pod": "src"}})
        out = [view, sorted(json.loads(raw)), j.PHASES, j.PHASE_DONE, j.OUTCOMES,
               _journal_view(j.parse_journal({j.ANNOT_JOURNAL: raw})),
               j.parse_journal({j.ANNOT_JOURNAL: "not json"}),
               j.parse_journal({j.ANNOT_JOURNAL: "{}"}),
               j.migration_active({j.ANNOT_JOURNAL: raw}),
               j.migration_active({j.ANNOT_LOCK: lock}),
               j.migration_active({j.ANNOT_LOCK: lock}, kube=kube)]
        done = dict(journal, outcome="succeeded")
        kube.patch_pod("default", "src", {"metadata": {"annotations": {
            j.ANNOT_JOURNAL: j.dump(done)}}})
        out.append(j.migration_active({j.ANNOT_LOCK: lock}, kube=kube))  # stale: ended
        kube.set_partitioned(True)
        out.append(j.migration_active({j.ANNOT_LOCK: lock}, kube=kube))  # an outage: stands
        kube.set_partitioned(False)
        kube.delete_pod("default", "src")
        out.append(j.migration_active({j.ANNOT_LOCK: lock}, kube=kube))  # gone: stale
        return out
    got = both(case)
    assert got["port"] == got["reference"]
    assert got["port"][8:] == ["m1", "m1", "m1", None, "m1", None]
