"""The tenant's watchers and telemetry: the port's against the JAX
package's, on the control plane's FakeKubeClient.

Each case runs once per package (``side``) with the same expectations, so
both see the same callbacks and stamp the same acks. The cases are the
reference's (``tests/test_migrate.py``, ``tests/test_elastic_reconcile.py``
and ``tests/test_tenant_telemetry.py``), driven here on a bare
FakeKubeClient.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

import pytest

from gpumounter_tpu.jaxside import heal as jheal
from gpumounter_tpu.jaxside import migrate as jmigrate
from gpumounter_tpu.jaxside import telemetry as jtelemetry
from gpumounter_tpu.k8s import errors as kerrors
from gpumounter_tpu.k8s.fake import FakeKubeClient
from gpumounter_tpu.k8s.types import Pod
from gpumounter_tpu.obs.tenants import parse_tenant_snapshot
from gpumounter_tpu_torch.torchside import _kube
from gpumounter_tpu_torch.torchside import heal as theal
from gpumounter_tpu_torch.torchside import migrate as tmigrate
from gpumounter_tpu_torch.torchside import telemetry as ttelemetry

SIDES = {"jax": (jheal, jmigrate, jtelemetry),
         "torch": (theal, tmigrate, ttelemetry)}


@pytest.fixture(params=list(SIDES))
def side(request):
    """(heal, migrate, telemetry) modules of one package."""
    return SIDES[request.param]


def _kube_with_pod() -> FakeKubeClient:
    kube = FakeKubeClient()
    kube.create_pod("default", {
        "metadata": {"name": "trainer", "namespace": "default"},
        "spec": {"containers": [{"name": "main"}]}})
    return kube


def _stamp(kube, key: str, value: dict) -> None:
    kube.patch_pod("default", "trainer", {
        "metadata": {"annotations": {key: json.dumps(value)}}})


def _annotations(kube) -> dict:
    return Pod(kube.get_pod("default", "trainer")).annotations


def _wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(what)


def _run(target, *args, **kwargs):
    """Start a watcher thread; returns (stop event, thread)."""
    stop = threading.Event()
    thread = threading.Thread(target=target, args=args,
                              kwargs={**kwargs, "stop": stop,
                                      "watch_timeout_s": 2.0}, daemon=True)
    thread.start()
    return stop, thread


def _stop(stop, thread) -> None:
    stop.set()
    thread.join(timeout=5.0)
    assert not thread.is_alive()


def test_annotation_names_match_the_control_plane():
    assert theal.ANNOT_REPLACED == jheal.ANNOT_REPLACED == "tpumounter.io/chip-replaced"
    assert tmigrate.ANNOT_PHASE == jmigrate.ANNOT_PHASE == "tpumounter.io/migration-phase"
    assert tmigrate.ANNOT_ACK == jmigrate.ANNOT_ACK == "tpumounter.io/migration-ack"
    assert ttelemetry.ANNOT_DISRUPTION == jtelemetry.ANNOT_DISRUPTION
    assert ttelemetry.TENANT_SCHEMA == jtelemetry.TENANT_SCHEMA
    assert ttelemetry.STEP_BUCKETS == jtelemetry.STEP_BUCKETS
    assert ttelemetry.DOWNTIME_BUCKETS == jtelemetry.DOWNTIME_BUCKETS


def test_watch_migration_delivers_and_acks(side):
    """Quiesce then resume delivered once each, acks stamped; a signal
    predating the watcher still fires (test_migrate.py)."""
    _, migrate, _ = side
    kube = _kube_with_pod()
    _stamp(kube, migrate.ANNOT_PHASE, {"id": "mig-7", "phase": "quiesce"})
    events = []
    stop, thread = _run(migrate.watch_migration, kube, "default", "trainer",
                        lambda s: events.append(("quiesce", s)),
                        on_resume=lambda s: events.append(("resume", s)))
    try:
        _wait_for(lambda: events, 5.0, "pre-existing signal not delivered")
        assert events[0] == ("quiesce", {"id": "mig-7", "phase": "quiesce"})
        _wait_for(lambda: migrate.ANNOT_ACK in _annotations(kube), 5.0, "no ack")
        ack = json.loads(_annotations(kube)[migrate.ANNOT_ACK])
        assert ack == {"id": "mig-7", "phase": "quiesced", "at": ack["at"]}

        _stamp(kube, migrate.ANNOT_PHASE, {"id": "mig-7", "phase": "quiesce"})
        time.sleep(0.3)
        assert len(events) == 1  # the same signal again: no second callback

        _stamp(kube, migrate.ANNOT_PHASE,
               {"id": "mig-7", "phase": "resume", "chips": ["a", "b"]})
        _wait_for(lambda: len(events) == 2, 5.0, "resume never delivered")
        assert events[1] == ("resume", {"id": "mig-7", "phase": "resume",
                                        "chips": ["a", "b"]})
        _wait_for(lambda: json.loads(_annotations(kube)[migrate.ANNOT_ACK])["phase"]
                  == "resumed", 5.0, "resume never acked")
    finally:
        _stop(stop, thread)


def test_watch_migration_acks_only_after_a_callback_returns(side):
    """No handler for a phase: seen, never acked. A raising callback: no
    ack, and the signal is delivered again until the callback returns."""
    _, migrate, _ = side
    kube = _kube_with_pod()
    _stamp(kube, migrate.ANNOT_PHASE, {"id": "mig-1", "phase": "checkpoint"})
    attempts = []

    def flaky_quiesce(signal):
        attempts.append(signal["id"])
        if len(attempts) == 1:
            raise RuntimeError("devices not visible yet")

    stop, thread = _run(migrate.watch_migration, kube, "default", "trainer",
                        flaky_quiesce)
    try:
        time.sleep(0.4)
        assert migrate.ANNOT_ACK not in _annotations(kube)  # no on_checkpoint
        _stamp(kube, migrate.ANNOT_PHASE, {"id": "mig-1", "phase": "quiesce"})
        _wait_for(lambda: len(attempts) == 2, 8.0, "raising callback not retried")
        _wait_for(lambda: migrate.ANNOT_ACK in _annotations(kube), 5.0, "no ack")
        assert json.loads(_annotations(kube)[migrate.ANNOT_ACK])["phase"] == "quiesced"
        time.sleep(0.3)
        assert len(attempts) == 2
    finally:
        _stop(stop, thread)


def test_heal_watcher_fires_on_marker(side):
    """A new heal generation calls back once; the same generation again
    does not (test_elastic_reconcile.py); the marker present at start is
    the baseline."""
    heal, _, _ = side
    kube = _kube_with_pod()
    _stamp(kube, heal.ANNOT_REPLACED, {"generation": 1, "removed": ["x"]})
    seen: list[dict] = []
    stop, thread = _run(heal.watch_chip_replacements, kube, "default", "trainer",
                        seen.append)
    try:
        time.sleep(0.3)
        assert not seen  # baseline skipped
        marker = {"generation": 2, "removed": ["tpu-fake-accel0"],
                  "added": ["tpu-fake-accel4"], "at": "now"}
        _stamp(kube, heal.ANNOT_REPLACED, marker)
        _wait_for(lambda: seen, 5.0, "heal watcher never fired")
        assert seen == [marker]
        _stamp(kube, heal.ANNOT_REPLACED, marker)
        time.sleep(0.3)
        assert len(seen) == 1
    finally:
        _stop(stop, thread)


def test_heal_watcher_catches_marker_stamped_while_watch_down(side):
    """A heal landing while the watch stream is broken is delivered by the
    re-read after the re-subscribe (test_elastic_reconcile.py)."""
    heal, _, _ = side
    kube = _kube_with_pod()
    broken = threading.Event()
    broken.set()
    orig_watch = kube.watch_pods

    def flaky_watch(*args, **kwargs):
        if broken.is_set():
            raise RuntimeError("watch down")
        return orig_watch(*args, **kwargs)

    kube.watch_pods = flaky_watch
    seen: list[dict] = []
    stop, thread = _run(heal.watch_chip_replacements, kube, "default", "trainer",
                        seen.append)
    try:
        time.sleep(0.2)
        _stamp(kube, heal.ANNOT_REPLACED,
               {"generation": 1, "removed": ["a"], "added": ["b"]})
        time.sleep(0.3)
        assert not seen
        broken.clear()
        _wait_for(lambda: seen, 10.0, "heal stamped during the outage never delivered")
        assert seen[0]["generation"] == 1
    finally:
        _stop(stop, thread)


def test_watchers_end_when_the_pod_goes(side):
    heal, migrate, telemetry = side
    kube = FakeKubeClient()
    # no pod at all: nothing to watch, returns at once
    heal.watch_chip_replacements(kube, "default", "trainer", lambda m: None)
    telemetry.watch_disruptions(kube, "default", "trainer", lambda m: None)
    kube = _kube_with_pod()
    stop, thread = _run(migrate.watch_migration, kube, "default", "trainer",
                        lambda s: None)
    time.sleep(0.2)
    kube.delete_pod("default", "trainer")
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    stop.set()


def test_watch_disruptions_delivers_each_new_seq(side):
    _, _, telemetry = side
    kube = _kube_with_pod()
    _stamp(kube, telemetry.ANNOT_DISRUPTION, {"seq": 3, "cause": "fence"})
    seen: list[dict] = []
    stop, thread = _run(telemetry.watch_disruptions, kube, "default", "trainer",
                        seen.append)
    try:
        time.sleep(0.3)
        assert not seen  # baseline
        marker = {"seq": 4, "cause": "evacuation", "trace_id": "t-9", "node": "n1"}
        _stamp(kube, telemetry.ANNOT_DISRUPTION, marker)
        _wait_for(lambda: seen, 5.0, "disruption never delivered")
        _stamp(kube, telemetry.ANNOT_DISRUPTION, {"seq": 2, "cause": "fence"})
        time.sleep(0.3)
        assert seen == [marker]
    finally:
        _stop(stop, thread)


@pytest.mark.parametrize("exc", [
    kerrors.ApiError(404), kerrors.NotFoundError("x"), kerrors.ApiError(409),
    kerrors.ApiError(0), kerrors.ServerError(500), kerrors.PartitionError("p"),
    kerrors.ApiTimeoutError("t"), ConnectionResetError(), TimeoutError(),
    FileNotFoundError(), PermissionError(), OSError("io"),
    http.client.RemoteDisconnected(), http.client.IncompleteRead(b""),
    ValueError("v"), RuntimeError("watch down")],
    ids=lambda e: type(e).__name__ + str(getattr(e, "status", "")))
def test_error_rules_match_the_control_plane(exc):
    assert _kube.is_outage(exc) == kerrors.is_outage(exc)
    assert _kube.is_not_found(exc) == (isinstance(exc, kerrors.ApiError)
                                       and exc.status == 404)


# --- TenantTelemetry ---

class FakeClock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


#: snapshot keys stamped from the wall clock, which the injected clock
#: does not drive
WALL_KEYS = {"at", "started_at", "ended_at", "last_at"}


def _without_wall(doc):
    if isinstance(doc, dict):
        return {k: _without_wall(v) for k, v in doc.items() if k not in WALL_KEYS}
    if isinstance(doc, list):
        return [_without_wall(v) for v in doc]
    return doc


def _drive(telemetry) -> list[dict]:
    """The same event sequence, on one package's TenantTelemetry: steps,
    a stall, a migration through the wrappers, a heal, an external
    disruption, minutes rolled; a snapshot after each part."""
    clock = FakeClock()
    tel = telemetry.TenantTelemetry(tenant="team-a/trainer", namespace="default",
                                    pod="trainer", clock=clock, minute_s=10.0,
                                    stall_min_s=1.0, stall_factor=10.0)
    snaps = []
    for _ in range(10):
        clock.advance(0.010)
        tel.record_step(0.010, tokens=512, queue_depth=4)
    snaps.append(tel.snapshot())
    clock.advance(3.0)
    clock.advance(0.010)
    tel.record_step(0.010, tokens=512)  # a stall window
    snaps.append(tel.snapshot())
    calls = []
    tel.migration_quiesce(lambda s: calls.append("q"))(
        {"id": "mig-9", "phase": "quiesce", "trace_id": "tr-99"})
    snaps.append(tel.snapshot())  # one window open
    clock.advance(0.4)
    tel.migration_resume(lambda s: calls.append("r"))(
        {"id": "mig-9", "phase": "resume", "trace_id": "tr-99"})

    def restore(marker):
        clock.advance(0.25)

    tel.heal(restore)({"generation": 3, "trace_id": "tr-heal"})
    tel.external_disruption({"seq": 1, "cause": "evacuation", "trace_id": "t-ev",
                             "node": "n1"})
    clock.advance(2.0)
    clock.advance(0.010)
    tel.record_step(0.010, tokens=256, queue_depth=2)
    clock.advance(25.0)  # rolls minutes
    with tel.step(tokens=64):
        clock.advance(0.02)
    snaps.append(tel.snapshot())
    assert calls == ["q", "r"]
    return snaps


def test_tenant_telemetry_snapshots_match_the_reference():
    want = [_without_wall(s) for s in _drive(jtelemetry)]
    got_raw = _drive(ttelemetry)
    assert [_without_wall(s) for s in got_raw] == want
    last = got_raw[-1]
    assert last["disruption"]["total_windows"] == 5  # two stalls
    assert {w["cause"] for w in last["disruption"]["windows"]} == {
        "stall", "migration", "heal", "evacuation"}
    assert last["minutes"]["total"] >= 2


def test_parse_tenant_snapshot_takes_the_port_s_snapshot():
    for snap in _drive(ttelemetry):
        body = json.dumps(snap).encode()
        assert parse_tenant_snapshot(body) == snap


def test_tenant_telemetry_defaults_come_from_the_control_plane_env(monkeypatch):
    for key in ("TENANT_PUBLISH_INTERVAL_S", "TENANT_STALL_FACTOR", "TENANT_STALL_MIN_S"):
        monkeypatch.delenv(key, raising=False)
    tel = ttelemetry.TenantTelemetry(tenant="t")
    assert (tel.publish_interval_s, tel.stall_factor, tel.stall_min_s) == (15.0, 10.0, 1.0)
    monkeypatch.setenv("TENANT_STALL_MIN_S", "2.5")
    monkeypatch.setenv("TENANT_PUBLISH_INTERVAL_S", "3")
    tel = ttelemetry.TenantTelemetry(tenant="t")
    assert (tel.publish_interval_s, tel.stall_min_s) == (3.0, 2.5)
    with pytest.raises(ValueError, match="non-empty"):
        ttelemetry.TenantTelemetry(tenant="")


def test_publish_to_a_dead_worker_is_advisory():
    tel = ttelemetry.TenantTelemetry(tenant="team-b/serve",
                                     publish_url="http://127.0.0.1:1")
    assert tel.publish(timeout_s=1.0) is False
    assert ttelemetry.TenantTelemetry(tenant="x").publish() is False  # no target
