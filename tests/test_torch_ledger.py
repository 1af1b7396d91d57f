"""The worker's mount ledger and its replay: the port's
``worker/ledger.py`` and ``worker/resync.py`` against the reference's.

The journal cases of ``tests/test_ledger.py`` run on both packages'
``MountLedger``; what each reads back (open txns, net holdings, epoch, the
clean marker) and the journal's lines, with ids and times masked, must be
equal. Then the worker's flows, each on a ``FakeCluster`` of 4 accelerators
a package (``tests/torch_durability.py``): a death at either site around the
grant, the worker's restart over the same ledger and the replay (forward
where the bookings survived, back where the pod went), the SIGTERM drain,
fractional grants through the mounter's ``policy=`` and their re-arming, and
a remove that fails part way, whose net holdings must be the reference's;
the deferred slave releases of ``tests/test_api_outage.py``; and the card's
``entry.durability_check`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
from torch_durability import SIDES, Refused
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.faults.failpoints import CrashError as RefCrashError
from gpumounter_tpu.k8s.errors import PartitionError as RefPartitionError
from gpumounter_tpu.worker import ledger as ref_ledger
from gpumounter_tpu.worker import server as ref_server
from gpumounter_tpu_torch.cgroup import ebpf
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.entry import durability_check
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.faults.failpoints import CrashError
from gpumounter_tpu_torch.k8s.errors import PartitionError
from gpumounter_tpu_torch.worker import ledger, server

PACKAGES = {"reference": (ref_ledger, RefConfig), "port": (ledger, Config)}


class _Dev:
    """A GPU as both ledgers read one: the reference's rel_path, the port's
    basename, the same value."""

    def __init__(self, uuid, slave=""):
        self.uuid = uuid
        self.rel_path = self.basename = uuid
        self.major, self.minor = 195, 0
        self.pod_name = slave


class _Target:
    description = "default/pod-a"
    dev_dir = "/tmp/dev"
    ns_pid = None
    cgroup_dirs = []

    class pod:  # noqa: N801 — a Pod's identity, duck-typed
        namespace = "default"
        name = "pod-a"
        uid = "uid-1"


def _lines(path: str) -> list[dict]:
    """The journal's records, ids numbered by appearance, times dropped."""
    ids: dict[str, str] = {}
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                out.append("<torn>")
                continue
            rec.pop("at", None)
            for key in ("txn", "rel"):
                if key in rec:
                    rec[key] = ids.setdefault(rec[key], f"{key}{len(ids)}")
            out.append(rec)
    return out


def _state(led) -> dict:
    return {"open": [t["chips"] for t in led.open_transactions()],
            "holdings": led.net_holdings(), "epoch": led.epoch(),
            "clean": led.was_clean_shutdown(), "releases": [r["pods"] for r in
                                                            led.pending_releases()]}


# --- the journal, case by case (tests/test_ledger.py's unit half) ---

def begin_commit_roundtrip(mod, d):
    led = mod.MountLedger(d)
    txn = led.begin("mount", target=_Target(), devices=[_Dev("gpu0", slave="s0")])
    mid = [t["txn"] == txn for t in led.open_transactions()]
    led.commit(txn, "success")
    return {"mid": mid, "end": _state(led)}


def crash_state_survives_reload(mod, d):
    led = mod.MountLedger(d)
    led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu0")]), "success")
    led.begin("mount", target=_Target(), devices=[_Dev("gpu1")])
    led.abandon()  # the death: no close
    return _state(mod.MountLedger(d))


def clean_shutdown_marker(mod, d):
    led = mod.MountLedger(d)
    led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu0")]), "success")
    led.close()
    led.close()  # idempotent
    return _state(mod.MountLedger(d))


def unmount_folds_out_of_holdings(mod, d):
    led = mod.MountLedger(d)
    led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu0"), _Dev("gpu1")]),
               "success")
    led.commit(led.begin("unmount", target=_Target(), devices=[_Dev("gpu0")]), "success")
    after_unmount = led.net_holdings()
    led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu2")]), "rolled-back")
    led.commit(led.begin("unmount", target=_Target(), devices=[_Dev("gpu1")]), "error")
    led.commit("m-0000000000", "success")  # an unknown id: a no-op
    return {"after_unmount": after_unmount, "end": _state(led)}


def epoch_is_persistent_and_monotonic(mod, d):
    led = mod.MountLedger(d)
    led.record_epoch(3)
    led.record_epoch(2)  # never goes back
    led.record_epoch(3)  # no append
    return {"epoch": led.epoch(), "reloaded": mod.MountLedger(d).epoch()}


def torn_final_line_is_dropped(mod, d):
    led = mod.MountLedger(d)
    led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu0")]), "success")
    with open(led.path, "a", encoding="utf-8") as f:
        f.write('{"kind":"txn","txn":"torn-')  # a death in the middle of an append
    return _state(mod.MountLedger(d))


def compaction_preserves_state(mod, d):
    led = mod.MountLedger(d, max_bytes=4096)
    for i in range(40):
        led.commit(led.begin("mount", target=_Target(), devices=[_Dev(f"gpu{i % 4}")]),
                   "success")
    led.begin("mount", target=_Target(), devices=[_Dev("gpu9")])
    led.record_epoch(7)
    rel = led.queue_release("pool", ["slave-b", "slave-a"])
    led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu3")]), "success")
    size = os.path.getsize(led.path)
    state = _state(mod.MountLedger(d))
    led.complete_release(rel)
    return {"small": size < 4096 * 4, "state": state,
            "compactions": mod.LEDGER_COMPACTIONS.total() > 0}


def open_ledger_disabled_and_unwritable(mod, d, cfg_cls):
    blocked = os.path.join(d, "blocked")
    os.makedirs(d, exist_ok=True)
    with open(blocked, "w") as f:
        f.write("a file, not a directory")
    return {"disabled": mod.open_ledger(dataclasses.replace(cfg_cls(), ledger_dir="")),
            "unwritable": mod.open_ledger(dataclasses.replace(cfg_cls(), ledger_dir=blocked))}


JOURNAL_CASES = [begin_commit_roundtrip, crash_state_survives_reload, clean_shutdown_marker,
                 unmount_folds_out_of_holdings, epoch_is_persistent_and_monotonic,
                 torn_final_line_is_dropped, compaction_preserves_state]


@pytest.mark.parametrize("case", JOURNAL_CASES + [open_ledger_disabled_and_unwritable],
                         ids=lambda c: c.__name__)
def test_a_journal_case_reads_back_as_the_references(tmp_path, case):
    got = {}
    for name, (mod, cfg_cls) in PACKAGES.items():
        d = str(tmp_path / name)
        if case is open_ledger_disabled_and_unwritable:
            got[name] = case(mod, d, cfg_cls)
            continue
        got[name] = (case(mod, d), _lines(os.path.join(d, mod.LEDGER_FILE)))
    if case is torn_final_line_is_dropped:
        # the difference on purpose (below): the port's reload cut the torn
        # tail off the file, the reference's left it
        assert got["reference"][1][-1] == "<torn>" and "<torn>" not in got["port"][1]
        got["reference"] = (got["reference"][0], got["reference"][1][:-1])
    assert got["port"] == got["reference"]
    if case is open_ledger_disabled_and_unwritable:
        assert got["port"] == {"disabled": None, "unwritable": None}


def test_the_ledger_series_are_the_references():
    for series in ("LEDGER_APPENDS", "LEDGER_OPEN_TXNS", "LEDGER_COMPACTIONS"):
        ours, ref = getattr(ledger, series), getattr(ref_ledger, series)
        assert (type(ours).__name__, ours.name, ours.help) == \
            (type(ref).__name__, ref.name, ref.help)


# --- the worker's flows, a death and the replay (the integration half) ---

@pytest.fixture()
def sides(tmp_path):
    made = {}

    def make(**kwargs):
        for name, cls in SIDES.items():
            made[name] = cls(str(tmp_path / name), **kwargs)
        return made

    yield make
    for side in made.values():
        side.close()


def _crash_add(side, site, pod="trainer", n=2):
    fp = ref_failpoints if side.kind == "reference" else failpoints
    crash = RefCrashError if side.kind == "reference" else CrashError
    with fp.armed({site: "1*crash(ledger-test)"}):
        with pytest.raises(crash):
            side.add(pod, n)


def _view(side, pods=("trainer",)) -> dict:
    return {"books": {p: side.books(p) for p in pods}, "mounted": side.mounted(),
            "holdings": side.holdings(), "open": side.open_txns(), "free": side.free()}


@pytest.mark.parametrize("site", ["worker.mount.before_grant", "worker.mount.after_grant"])
def test_a_death_in_the_mount_replays_as_the_references(sides, site):
    """Both sites leave the slave pods booked, so the replay drives the
    mount forward: books == mounts == ledger, as in the reference, and the
    journals are equal line by line."""
    got = {}
    for name, side in sides().items():
        side.add_pod("trainer")
        _crash_add(side, site)
        crashed = side.open_txns()
        side.restart()
        summary = side.replay()
        got[name] = (crashed, summary, _view(side), side.journal())
    assert got["port"] == got["reference"]
    crashed, summary, view, _ = got["port"]
    assert crashed == 1 and summary["open"] == 1 and summary["completed"] == 1
    assert view["books"]["trainer"] == view["mounted"] == view["holdings"][("default", "trainer")]
    assert len(view["mounted"]) == 2 and view["open"] == 0


def test_the_replay_rolls_back_when_the_bookings_are_gone(sides):
    """A completed mount, then a death after the grant of another pod's;
    both pods deleted while the worker was down: the open txn is rolled
    back and the closed mount's holdings forgotten."""
    got = {}
    for name, side in sides().items():
        side.add_pod("trainer")
        assert side.add("trainer", 2) == 0
        side.add_pod("other")
        _crash_add(side, "worker.mount.after_grant", pod="other", n=1)
        side.restart()
        side.delete_pod("other")
        side.delete_pod("trainer")
        got[name] = (side.replay(), side.holdings(), side.open_txns(), side.free(),
                     side.journal())
    assert got["port"] == got["reference"]
    summary, holdings, open_txns, free, _ = got["port"]
    assert summary["rolled_back"] == 1 and summary["holdings_corrected"] >= 2
    assert holdings == {} and open_txns == 0


def test_the_sigterm_drain_closes_the_ledger_clean(sides):
    """drain() lets the work finish, closes the ledger with its marker, and
    refuses the next mutation as draining; a single-GPU round trip's
    journal is the reference's line by line."""
    got = {}
    for name, side in sides().items():
        side.add_pod("trainer")
        assert side.add("trainer", 1) == 0
        (held,) = side.mounted()
        assert side.remove("trainer", [held]) == 0
        assert side.add("trainer", 1) == 0
        clean = side.service.drain(timeout_s=5.0)
        mod = ref_ledger if name == "reference" else ledger
        reloaded = mod.MountLedger(side.ledger_dir)
        with pytest.raises(Refused) as refused:
            side.add("trainer", 1)
        got[name] = (clean, reloaded.was_clean_shutdown(), reloaded.open_transactions(),
                     refused.value.code, "draining" in refused.value.message, side.journal())
        reloaded.abandon()
    assert got["port"] == got["reference"]
    assert got["port"][:5] == (True, True, [], "UNAVAILABLE", True)


@pytest.fixture()
def _policy_engines():
    """Both packages' userspace policy engines, empty around the test."""
    engines = [cls.policy_engine for cls in SIDES.values()]
    for engine in engines:
        engine.reset()
    yield
    for engine in engines:
        engine.reset()


def test_fractional_grants_journal_and_replay_as_the_references(sides, _policy_engines):
    """A mount through the mounter's policy= journals (weight, budget) a
    GPU; a whole-GPU mount journals none; after a death the replay re-arms
    the engine at the same weight and budget."""
    got = {}
    for name, side in sides().items():
        mod = ref_ebpf if name == "reference" else ebpf
        side.add_pod("trainer")
        side.share_mount("trainer", 2, weight=60, budget=8)
        side.add_pod("legacy")
        assert side.add("legacy", 1) == 0
        shares = {k: {side.indices([u]).pop(): v for u, v in s.items()}
                  for k, s in side.service.ledger.share_holdings().items()}
        side.restart()
        side.policy_engine.reset()  # the table died with the process
        summary = side.replay()
        entries = side.policy_engine.entries("default/trainer")
        got[name] = (shares, summary,
                     sorted({(mod.policy_weight(v), mod.policy_tokens(v))
                             for v in entries.values()}),
                     side.policy_engine.entries("default/legacy"), side.journal())
    assert got["port"] == got["reference"]
    shares, summary, values, legacy, _ = got["port"]
    assert set(shares) == {("default", "trainer")} and len(shares[("default", "trainer")]) == 2
    assert summary["share_policies_replayed"] == 2 and values == [(60, 8)] and legacy == {}


def test_a_remove_that_fails_part_way_holds_the_references_net_holdings(sides, monkeypatch):
    """The second of three node removals fails. The reference unmounts a
    GPU at a time, one txn each (the first success, the second error, the
    third never begun); the port journals all three, then closes the first
    success and the others error. The net holdings are equal: the GPU
    unmounted before the failure is gone from them."""
    from gpumounter_tpu.nsutil import ns as ref_ns
    from gpumounter_tpu_torch.nsutil import nsexec
    made = sides()
    failing = {}
    for name, side in made.items():
        side.add_pod("trainer")
        assert side.add("trainer", 3) == 0
        failing[name] = sorted(side.mounted())[1]
    ref_remove = ref_ns.remove_device_file

    def ref_refuse(dev_dir, dev, pid=None):
        if dev.index == failing["reference"]:
            raise OSError(16, "Device or resource busy", os.path.join(dev_dir, dev.rel_path))
        ref_remove(dev_dir, dev, pid=pid)

    port_side = made["port"]
    port_failing = os.path.join(port_side.dev, os.path.basename(
        port_side.backend.device_by_uuid(port_side.uuids([failing["port"]])[0]).device_path))
    unlink = nsexec.unlink_here

    def port_refuse(path):
        if path == port_failing:
            raise OSError(16, "Device or resource busy", path)
        unlink(path)

    monkeypatch.setattr(ref_ns, "remove_device_file", ref_refuse)
    monkeypatch.setattr(nsexec, "unlink_here", port_refuse)
    got = {}
    for name, side in made.items():
        with pytest.raises(Refused) as refused:
            side.remove("trainer", sorted(side.mounted()))
        outcomes = sorted(r["outcome"] for r in side.journal() if r["kind"] == "done")
        got[name] = (refused.value.code, side.holdings(), side.books("trainer"),
                     side.mounted(), side.open_txns(), outcomes)
    code, holdings, books, mounted, open_txns, outcomes = got["port"]
    ref = got["reference"]
    assert (code, holdings, books, mounted, open_txns) == ref[:5]
    assert holdings[("default", "trainer")] == books == mounted and len(mounted) == 2
    # the port closes the GPU never reached as error, where the reference never began it
    assert outcomes == sorted(ref[5] + ["error"])


# --- the deferred slave releases (tests/test_api_outage.py's two cases) ---

def test_the_release_queue_is_durable_as_the_references(tmp_path):
    got = {}
    for name, (mod, _) in PACKAGES.items():
        d = str(tmp_path / name)
        led = mod.MountLedger(d)
        rel = led.queue_release("pool", ["slave-a", "slave-b"])
        steps = [[r["pods"] for r in led.pending_releases()]]
        led.abandon()  # the death
        reloaded = mod.MountLedger(d)
        steps.append([r["rel"] == rel for r in reloaded.pending_releases()])
        reloaded.complete_release(rel)
        reloaded.complete_release(rel)  # idempotent
        steps.append(reloaded.pending_releases())
        reloaded.abandon()
        third = mod.MountLedger(d)
        steps.append(third.pending_releases())  # the done record persisted
        third.abandon()
        got[name] = (steps, _lines(os.path.join(d, mod.LEDGER_FILE)))
    assert got["port"] == got["reference"]
    assert got["port"][0] == [[["slave-a", "slave-b"]], [True], [], []]


def _fail_deletes(side):
    fp = ref_failpoints if side.kind == "reference" else failpoints
    return fp.armed({"k8s.delete_pod.status": "return(503)"})


def test_a_deferred_retry_probes_one_record_while_deletes_fail(sides):
    """retry_pending_releases(limit=1) tries one record's delete, not every
    one's, and reports the whole backlog; once deletes land, all close."""
    got = {}
    for name, side in sides().items():
        service = side.service
        for i in range(4):
            service.ledger.queue_release(side.cluster.cfg.pool_namespace, [f"slave-{i}"])
        attempts = []
        delete = side.cluster.kube.delete_pod

        def counting(namespace, pod, _delete=delete, **kwargs):
            attempts.append(pod)
            return _delete(namespace, pod, **kwargs)

        side.cluster.kube.delete_pod = counting
        with _fail_deletes(side):
            during = service.retry_pending_releases(limit=1)
        got[name] = (list(attempts), during, service.retry_pending_releases(),
                     service.ledger.pending_releases())
    assert got["port"] == got["reference"] == (
        ["slave-0"], {"completed": 0, "pending": 4}, {"completed": 4, "pending": 0}, [])


def test_a_failed_slave_release_defers_into_the_ledger(sides):
    """With a ledger, a remove whose slave pod cannot be deleted answers
    Success: the pod goes into the ledger's queue (the deferred series
    moves), its GPU stays booked until the retry deletes it; the restart's
    replay retries too. As the reference."""
    got = {}
    for name, side in sides().items():
        mod = ref_server if name == "reference" else server
        side.add_pod("trainer")
        assert side.add("trainer", 1) == 0
        deferred0 = mod.SLAVE_RELEASE_DEFERRED.total()
        with _fail_deletes(side):
            result = side.remove("trainer", side.mounted())
        pending = side.service.ledger.pending_releases()
        steps = [result, len(pending), mod.SLAVE_RELEASE_DEFERRED.total() - deferred0,
                 side.free(), side.mounted()]
        side.restart()  # the replay retries the queue, deletes failing still
        with _fail_deletes(side):
            steps.append(side.replay()["releases_pending"])
        steps += [side.service.retry_pending_releases(), side.free(), side.journal()]
        got[name] = steps
    assert got["port"] == got["reference"]
    assert got["port"][:8] == [0, 1, 1.0, 3, set(), 1, {"completed": 1, "pending": 0}, 4]


def test_without_a_ledger_a_failed_slave_release_raises(tmp_path):
    """No ledger: the leak is counted, the pod gets GPUSlaveReleaseFailed,
    and the remove raises INTERNAL (the reference answers Success and keeps
    only the count and the Event; ROADMAP.md section 3)."""
    side = SIDES["port"](str(tmp_path), ledger=False)
    try:
        side.add_pod("trainer")
        assert side.add("trainer", 1) == 0
        leaked0 = server.SLAVE_RELEASE_FAILURES.total()
        with _fail_deletes(side), pytest.raises(Refused) as refused:
            side.remove("trainer", side.mounted())
        reasons = [m["reason"] for _, m in side.cluster.kube.events_posted]
        assert refused.value.code == "INTERNAL" and "not released" in refused.value.message
        assert server.SLAVE_RELEASE_FAILURES.total() - leaked0 == 1
        assert "GPUSlaveReleaseFailed" in reasons and side.free() == 3
    finally:
        side.close()


# --- the card's check, on the CPU ---

def test_durability_check_on_the_cpu():
    """All of entry.durability_check on the fake host: the ledger's cost
    (2 appends an add and a remove), the replays forward and back, the
    fence, the drain, the deferred release and the reap."""
    report = durability_check("cpu", repeats=2)
    flows = report["fake"]
    assert report["live"] is None
    assert flows["cost"]["appends_add"] == flows["cost"]["appends_remove"] == [2, 2]
    assert len(flows["cost"]["with"]["add_ms"]) == len(flows["cost"]["without"]["add_ms"]) == 2
    assert len(flows["forward"]["summary"]["completed"]) == 1
    assert len(report["rolled_back"]["summary"]["rolled_back"]) == 1
    assert flows["fence"]["master"][0] == 503 and flows["fence"]["epoch_after_restart"] == 5
    assert "worker draining" in flows["drain"]["refused"]
    assert report["deferred"]["deferred"] == 1 and len(report["deferred"]["reaped"]) == 1


def test_durability_check_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        durability_check()


def test_the_next_release_probes_the_queue_with_one_record_first(sides):
    """Before a release, the worker retries one deferred record while its
    ApiHealth's write plane is unhealthy, and every record once it is
    healthy: the reference's rule (``write_plane_ok``), on both services.
    The probe's own successes bring the plane back."""
    got = {}
    for name, side in sides().items():
        service = side.service
        failure = (RefPartitionError if name == "reference" else PartitionError)("outage")
        for i in range(3):
            service.ledger.queue_release(side.cluster.cfg.pool_namespace, [f"queued-{i}"])
        attempts = []
        delete = side.cluster.kube.delete_pod

        def counting(namespace, pod, _delete=delete, **kwargs):
            if pod.startswith("queued-"):
                attempts.append(pod)
            return _delete(namespace, pod, **kwargs)

        side.cluster.kube.delete_pod = counting
        side.add_pod("trainer")
        steps = []
        for degrade in (True, False):
            assert side.add("trainer", 1) == 0
            if degrade:  # the add's writes went through: the outage begins now
                for _ in range(service.apihealth.degraded_failures):
                    service.apihealth.record_failure(failure, kind="write")
            steps.append(service.apihealth.write_plane_ok())
            assert side.remove("trainer", side.mounted()) == 0
            steps += [list(attempts), len(service.ledger.pending_releases()),
                      service.apihealth.write_plane_ok()]
            attempts.clear()
        got[name] = steps
    assert got["port"] == got["reference"] == [
        False, ["queued-0"], 2, True, True, ["queued-1", "queued-2"], 0, True]


def _fail_one_epoch_append(monkeypatch, journal):
    """The journal's next epoch record raises as a full disk would."""
    append, failed = journal._append, []

    def once(record):
        if record.get("kind") == "epoch" and not failed:
            failed.append(record)
            raise OSError(28, "No space left on device")
        return append(record)

    monkeypatch.setattr(journal, "_append", once)
    return failed


def test_an_epoch_whose_append_failed_is_written_by_the_next_call(tmp_path, monkeypatch):
    """The ledger takes an epoch only once its record is on disk, so the
    next record_epoch of the same epoch writes it (the reference takes it
    first and never writes it; ROADMAP.md section 3)."""
    journal = ledger.MountLedger(str(tmp_path))
    journal.record_epoch(3)
    failed = _fail_one_epoch_append(monkeypatch, journal)
    with pytest.raises(OSError):
        journal.record_epoch(7)
    assert failed and journal.epoch() == 3
    journal.record_epoch(7)
    journal.abandon()
    assert ledger.MountLedger(str(tmp_path)).epoch() == 7


def test_a_worker_refuses_a_mutation_whose_epoch_was_not_persisted(tmp_path, monkeypatch):
    """An epoch append that fails refuses the call UNAVAILABLE with nothing
    mounted; the next call with that epoch writes it, and after a restart
    the worker reads it back and fences an older one."""
    side = SIDES["port"](str(tmp_path))
    try:
        side.add_pod("trainer")
        _fail_one_epoch_append(monkeypatch, side.service.ledger)
        with pytest.raises(Refused) as refused:
            side.add("trainer", 1, epoch=5)
        assert (refused.value.code, side.free(), side.mounted()) == ("UNAVAILABLE", 4, set())
        assert refused.value.message.startswith("epoch 5 not persisted")
        assert side.add("trainer", 1, epoch=5) == 0
        side.restart()
        assert side.service.ledger.epoch() == 5
        with pytest.raises(Refused) as fenced:
            side.add("trainer", 1, epoch=4)
        assert fenced.value.code == "FAILED_PRECONDITION" and side.free() == 3
    finally:
        side.close()


def test_a_reload_cuts_the_torn_tail_so_the_next_txn_survives_the_next(tmp_path):
    """After a death in an append, the reload cuts the fragment off the
    file: the next batch's records start a line of their own, and a second
    reload still holds its GPU. The reference leaves the fragment, the next
    txn is appended onto it, and its second reload loses the mount."""
    got = {}
    for name, (mod, _) in PACKAGES.items():
        d = str(tmp_path / name)
        led = mod.MountLedger(d)
        led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu0")]), "success")
        led.abandon()
        with open(led.path, "a", encoding="utf-8") as f:
            f.write('{"kind":"txn","txn":"torn-')  # a death in the middle of an append
        led = mod.MountLedger(d)
        led.commit(led.begin("mount", target=_Target(), devices=[_Dev("gpu1")]), "success")
        led.abandon()
        got[name] = _state(mod.MountLedger(d))["holdings"]
    assert got["port"] == {("default", "pod-a"): {"gpu0", "gpu1"}}
    assert got["reference"] == {("default", "pod-a"): {"gpu0"}}


def test_the_ledger_fsyncs_its_directory_on_create_and_compaction(tmp_path, monkeypatch):
    """A new file and a compaction's rename reach the directory's entry:
    after a node crash it names the file the fsync'd appends went into."""
    synced = []
    fsync_dir = ledger._fsync_dir
    monkeypatch.setattr(ledger, "_fsync_dir", lambda d: (synced.append(d), fsync_dir(d)))
    journal = ledger.MountLedger(str(tmp_path))
    assert synced == [str(tmp_path)]
    journal.abandon()
    journal = ledger.MountLedger(str(tmp_path), max_bytes=4096)
    assert synced == [str(tmp_path)]
    compactions = ledger.LEDGER_COMPACTIONS.total()
    while ledger.LEDGER_COMPACTIONS.total() == compactions:
        journal.commit(journal.begin("mount", target=_Target(), devices=[_Dev("gpu-a")]),
                       "success")
    assert synced == [str(tmp_path)] * 2
    journal.abandon()
    assert ledger.MountLedger(str(tmp_path)).net_holdings() == {("default", "pod-a"): {"gpu-a"}}

