"""The live migration: move a tenant's GPUs from one pod to another without
a restart.

The counterpart of ``gpumounter_tpu/migrate/orchestrator.py``. The machine
runs these phases, each journaled on the source pod before the next:

    quiesce     signal the tenant (tpumounter.io/migration-phase), whose
                ``torchside.watch_migration`` packs its state with
                ``HotResumable``; poll the worker's QuiesceStatus for the ack
    checkpoint  (asked for with begin(checkpoint=True)) wait for the
                tenant's ack that its pack is saved on the host, before any
                GPU is drained: the drain window shrinks to a host copy
    drain       RemoveGPU, forced, of the whole set on the source
    remount     AddGPU of as many on the destination through the slice
                coordinator (all or nothing over the set)
    resume      stamp the destination, whose tenant restores; the downtime
                clock stops at the tenant's resume ack
    verify      ProbeGPU on every moved GPU: one that is not healthy rolls
                the whole migration back to the source

A master's restart drives an interrupted migration on from its last
journaled phase (``resume_interrupted``), and every phase can be entered
again: the drain removes only what the source still holds, the remount
diffs against the destination's set before it. While the API is not
healthy the machine waits at its next phase boundary (``paused_for_api``),
and a phase that failed during an outage is run again after it rather than
rolled back, a phase that met the partition before ApiHealth's verdict
flipped too (the reference's rolls back in that race). The remount and the
rollback leave out the reference's ``prefer_ici=True`` (``orchestrator.py:635,
801``): the port's slice has no ICI placement, and a host's GPUs are joined
by NVSwitch.

The Events take the GPU names (``GPUMigrationStarted``,
``GPUMigrationSucceeded``, ``GPUMigrationRolledBack``; the reference's
``TPU*``); the journal's fields, the annotations, the audit record
``migrate`` and the three series are the reference's.
"""

from __future__ import annotations

import copy
import json
import secrets
import threading
import time

from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.faults.failpoints import CrashError
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.errors import is_outage
from gpumounter_tpu_torch.k8s.events import post_pod_event
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.shard import epoch_kwargs
from gpumounter_tpu_torch.migrate.journal import (
    ANNOT_JOURNAL,
    ANNOT_LOCK,
    ANNOT_PHASE,
    PHASE_DONE,
    migration_active,
    new_journal,
)
from gpumounter_tpu_torch.obs import trace
from gpumounter_tpu_torch.obs.audit import AUDIT
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("migrate")

MIGRATIONS_TOTAL = REGISTRY.counter(
    "tpumounter_migrations_total",
    "Finished migrations by final phase reached and outcome")
MIGRATION_PHASE_DURATION = REGISTRY.histogram(
    "tpumounter_migration_phase_duration_seconds",
    "Wall time per migration phase")
MIGRATION_DOWNTIME = REGISTRY.histogram(
    "tpumounter_migration_downtime_seconds",
    "Tenant pack->restore gap (drain start to resume ack)")

#: the Events of a migration (the reference's TPUMigration*)
STARTED_REASON = "GPUMigrationStarted"
SUCCEEDED_REASON = "GPUMigrationSucceeded"
ROLLED_BACK_REASON = "GPUMigrationRolledBack"


class MigrationError(RuntimeError):
    """A failure in flight: the machine rolls back to the source."""

    def __init__(self, message: str, status: int = 500):
        super().__init__(message)
        self.status = status


class MigrationRejected(MigrationError):
    """A client's error, before anything moved (HTTP 4xx)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message, status)


class _Aborted(Exception):
    pass


class MigrationCoordinator:
    """The master's side: one thread a migration."""

    #: the phases in which an abort still rolls back: past the remount the
    #: GPUs are on the destination, and finishing forward is safer than a
    #: second move
    ABORTABLE_PHASES = ("quiesce", "checkpoint", "drain", "remount")

    def __init__(self, kube: KubeClient, registry, client_factory, cfg=None, store=None,
                 shards=None, apihealth=None):
        """store: the master's ``MasterStore`` (journals, the phase and lock
        stamps), by default the list-backed one; shards: a ``ShardManager``,
        whose active replicas adopt only the journals whose source pod is on
        a node they own; apihealth: the ``ApiHealth`` verdict the machine
        waits on at a phase boundary (its journal writes defer into the
        store's write-behind queue meanwhile)."""
        self.cfg = cfg or Config()
        self.kube = kube
        self.registry = registry
        self.client_factory = client_factory
        self.apihealth = apihealth
        if store is None:
            from gpumounter_tpu_torch.store.k8s import KubeMasterStore
            store = KubeMasterStore(kube, self.cfg)
        self.store = store
        self.shards = shards
        self._lock = OrderedLock("migrate.journals")
        # serializes begin(): the check that neither pod is taken and the
        # journal's persist are one step, or two /migrate for one pod both
        # pass and stomp each other's journal
        self._admission = OrderedLock("migrate.admission")
        self._journals: dict[str, dict] = {}   # id -> the last persisted copy
        self._threads: dict[str, threading.Thread] = {}
        self._aborts: set[str] = set()
        #: (namespace, pod) -> the node last resolved, so that a failed pod
        #: GET cannot drop the fencing epoch from a machine's mutation
        self._node_cache: dict[tuple[str, str], str] = {}

    # --- the public surface (the HTTP routes land here) ---

    def begin(self, source_ns: str, source_pod: str, dest_ns: str, dest_pod: str,
              checkpoint: bool = False) -> dict:
        """Check, journal phase=quiesce, lock the destination and start the
        machine; the journal as begun. checkpoint=True adds the checkpoint
        phase. MigrationRejected (4xx) before anything moved."""
        if (source_ns, source_pod) == (dest_ns, dest_pod):
            raise MigrationRejected("source and destination are the same pod", 400)
        # the slow checks (pod GETs, the worker, the probe) run outside the
        # admission mutex, so that one slow worker cannot serialize every
        # other /migrate behind its deadline; the set is read again at drain
        src_addr = self._worker_addr(source_ns, source_pod)
        self._worker_addr(dest_ns, dest_pod)
        chips = self._probe(src_addr, source_ns, source_pod)
        if not chips:
            raise MigrationRejected(f"pod {source_ns}/{source_pod} holds no tpumounter-managed "
                                    f"chips; nothing to migrate", 400)
        with self._admission:
            # re-read both pods, check neither is taken, and persist the
            # journal and the destination's lock before the mutex goes: a
            # concurrent begin() for either pod then sees the claim
            src = self._get_pod_checked(source_ns, source_pod)
            dst = self._get_pod_checked(dest_ns, dest_pod)
            for pod in (src, dst):
                active = migration_active(pod.annotations, kube=self.kube)
                if active:
                    raise MigrationRejected(f"pod {pod.namespace}/{pod.name} is already part of "
                                            f"migration {active}", 409)
            mid = f"mig-{secrets.token_hex(5)}"
            journal = new_journal(mid, source_ns, source_pod, dest_ns, dest_pod)
            journal["checkpoint"] = bool(checkpoint)
            # the whole migration, on whichever master drives it after a
            # crash, runs under the trace of the /migrate edge: the journal
            # carries it
            journal["trace_id"] = trace.current_trace_id() or trace.new_trace_id()
            self._persist(journal)
            try:
                self._stamp(journal["destination"], ANNOT_LOCK,
                            {"id": mid, "role": "destination", "source": journal["source"]})
            except Exception as exc:  # noqa: BLE001 — withdraw the claim: a
                # journal with no thread would wedge both pods (409, the
                # reconciler paused) until a restart's resume scan
                logger.error("destination lock stamp failed; withdrawing migration %s: %s",
                             mid, exc)
                try:
                    self.kube.patch_pod(source_ns, source_pod,
                                        {"metadata": {"annotations": {ANNOT_JOURNAL: None}}})
                except Exception as undo_exc:  # noqa: BLE001 — the resume scan
                    # sweeps a journal left behind
                    logger.warning("journal withdrawal for %s failed (%s): %s", mid,
                                   "api outage" if is_outage(undo_exc) else "api error",
                                   undo_exc)
                with self._lock:
                    self._journals.pop(mid, None)
                raise MigrationError(f"could not lock destination pod: {exc}", 500)
        post_pod_event(self.kube, src, STARTED_REASON,
                       f"migration {mid}: moving {len(chips)} chip(s) to {dest_ns}/{dest_pod}",
                       component="tpumounter-migrate")
        # copied before the thread starts: it mutates this dict
        response = copy.deepcopy(journal)
        self._spawn(journal)
        return response

    def get(self, mid: str) -> dict | None:
        with self._lock:
            journal = self._journals.get(mid)
            if journal is not None:
                return copy.deepcopy(journal)
        for journal in self._scan():
            if journal["id"] == mid:
                return journal
        return None

    def list_migrations(self) -> list[dict]:
        out: dict[str, dict] = {j["id"]: j for j in self._scan()}
        with self._lock:
            for mid, journal in self._journals.items():
                out[mid] = copy.deepcopy(journal)  # the memory is fresher
        return sorted(out.values(), key=lambda j: j.get("created_at", 0))

    def abort(self, mid: str) -> dict:
        journal = self.get(mid)
        if journal is None:
            raise MigrationRejected(f"no migration {mid}", 404)
        if journal.get("outcome"):
            raise MigrationRejected(f"migration {mid} already finished ({journal['outcome']})",
                                    409)
        if journal["phase"] not in self.ABORTABLE_PHASES:
            raise MigrationRejected(f"too late to abort {mid}: phase {journal['phase']} has "
                                    f"already re-mounted the chips", 409)
        with self._lock:
            self._aborts.add(mid)
        return {"id": mid, "aborting": True}

    def wait(self, mid: str, timeout_s: float = 60.0) -> dict | None:
        """Block until the machine ends (or `timeout_s`); the journal."""
        with self._lock:
            thread = self._threads.get(mid)
        if thread is not None:
            thread.join(timeout=timeout_s)
        return self.get(mid)

    def resume_interrupted(self) -> list[str]:
        """Adopt and drive every journal found that is not terminal (the
        master's restart); the ids adopted."""
        adopted = []
        for journal in self._scan():
            if journal.get("outcome") is not None or not self._owns_journal(journal):
                continue
            with self._lock:
                if journal["id"] in self._threads:
                    continue
            logger.warning("adopting interrupted migration %s (phase %s)", journal["id"],
                           journal["phase"])
            self._spawn(journal)
            adopted.append(journal["id"])
        return adopted

    def stop(self) -> None:
        with self._lock:
            threads = list(self._threads.values())
        for thread in threads:
            thread.join(timeout=5.0)

    def _node_epoch(self, namespace: str, pod_name: str) -> dict:
        """The fencing epoch of a pod's node, for the machine's drains and
        rollback removes: a machine that runs on in a replica that lost the
        shard keeps stamping its stale epoch, and the worker fences it (the
        stamp is not gated on ownership). A failed pod GET falls back to the
        node this machine resolved last; {} unsharded, or for a pod never
        resolved."""
        if self.shards is None or not self.shards.active():
            return {}
        key = (namespace, pod_name)
        try:
            node = Pod(self.kube.get_pod(namespace, pod_name)).node_name
        except Exception as exc:  # noqa: BLE001 — the cache is the evidence
            logger.warning("node resolution for %s/%s degraded to cache (%s): %s", namespace,
                           pod_name, "api outage" if is_outage(exc) else "api error", exc)
            node = self._node_cache.get(key, "")
        if node:
            self._node_cache[key] = node
        return epoch_kwargs(self.shards, node or "")

    def _owns_journal(self, journal: dict) -> bool:
        """With the shards active a replica adopts only the journals whose
        source pod is on a node it owns (two drivers of one machine would
        drive it twice); a source it cannot read is skipped this pass."""
        if self.shards is None or not self.shards.active():
            return True
        src = journal["source"]
        try:
            pod = Pod(self.kube.get_pod(src["namespace"], src["pod"]))
        except NotFoundError:
            return False
        except Exception as exc:  # noqa: BLE001 — ownership unproven: skip
            (logger.debug if is_outage(exc) else logger.warning)(
                "ownership check for %s skipped: %s", journal["id"], exc)
            return False
        return bool(pod.node_name) and self.shards.owns_node(pod.node_name)

    # --- the machine ---

    def _spawn(self, journal: dict) -> None:
        with self._lock:
            self._journals[journal["id"]] = copy.deepcopy(journal)
            thread = threading.Thread(target=self._run, args=(journal,),
                                      name=f"migration-{journal['id']}", daemon=True)
            self._threads[journal["id"]] = thread
        thread.start()

    def _run(self, journal: dict) -> None:
        # the journal's trace, on this thread: the phases' spans (and the
        # workers' behind them) join the /migrate edge's trace, across a
        # master's restart too
        ctx = trace.TraceContext(journal.get("trace_id") or trace.new_trace_id())
        with trace.attached(ctx):
            self._run_traced(journal)

    def _run_traced(self, journal: dict) -> None:
        mid = journal["id"]
        final_phase = journal["phase"]
        crashed = False
        early_holds = 0  # holds on a streak under the verdict, this phase
        try:
            while journal["phase"] != PHASE_DONE:
                phase = journal["phase"]
                final_phase = phase
                self._await_api_healthy(journal)
                if mid in self._aborts and phase in self.ABORTABLE_PHASES:
                    raise _Aborted(f"abort requested during {phase}")
                started = time.monotonic()
                try:
                    with trace.span(f"migrate.{phase}", id=mid):
                        # the crash site at every phase boundary
                        failpoints.fire(f"migrate.phase.{phase}", id=mid)
                        next_phase = getattr(self, f"_phase_{phase}")(journal)
                except (CrashError, _Aborted):
                    raise
                except Exception as exc:  # noqa: BLE001 — the outage's check
                    if self.apihealth is None:
                        raise
                    if self.apihealth.ok():
                        # the API's calls failing, its verdict not yet flipped
                        # (the partition met this phase first): the phase runs
                        # again, and its own failures flip the verdict within
                        # the threshold's count. A streak that outlives them
                        # is not the API's outage
                        if not self.apihealth.failing() \
                                or early_holds >= self.apihealth.degraded_failures:
                            raise
                        early_holds += 1
                        time.sleep(self.cfg.migrate_poll_interval_s)
                    else:
                        early_holds = 0
                    # the phase failed while the API was away: a rollback now
                    # would drive more mutations against a cluster we can
                    # neither read nor journal to. Hold at this boundary; the
                    # phase runs again after the heal (each is re-entrant),
                    # and a real failure rolls back then
                    logger.warning("migration %s: phase %s failed during api outage "
                                   "(%s); holding at boundary for post-heal retry", mid,
                                   phase, exc)
                    continue
                early_holds = 0
                elapsed = time.monotonic() - started
                MIGRATION_PHASE_DURATION.observe(elapsed, phase=phase)
                journal["phase_durations_s"][phase] = round(elapsed, 3)
                journal["phase"] = next_phase
                self._persist(journal)
            if mid in self._aborts:
                # an abort that came while the remount finished: too late,
                # but the caller was told "aborting", so say it was overtaken
                journal["abort_too_late"] = True
                logger.warning("migration %s: abort request arrived after the chips moved; "
                               "finished forward", mid)
                self._persist(journal)
            logger.info("migration %s finished: %s", mid, journal["outcome"])
        except _Aborted as exc:
            self._rollback(journal, str(exc), outcome="aborted")
        except CrashError as exc:
            # a simulated master death: no rollback, no outcome, as a real
            # crash leaves it; the journal stays at its last phase for a
            # restart's resume_interrupted
            crashed = True
            logger.error("migration %s: simulated crash (%s); journal left at phase %s for "
                         "resume", mid, exc, journal["phase"])
        except Exception as exc:  # noqa: BLE001 — the terminal boundary
            if not isinstance(exc, MigrationError):
                logger.exception("migration %s: unexpected failure in phase %s", mid,
                                 final_phase)
            if journal.get("outcome") == "succeeded":
                # the housekeeping after the success failed (the terminal
                # persist on a deleted source, a stamp): the GPUs are
                # verified on the destination, and a rollback now would pull
                # them from under the tenant. The memory's copy is terminal
                logger.warning("migration %s: post-success cleanup failed (%s); outcome "
                               "stays succeeded", mid, exc)
                journal["phase"] = PHASE_DONE
                with self._lock:
                    self._journals[mid] = copy.deepcopy(journal)
            else:
                self._rollback(journal, str(exc))
        finally:
            if not crashed:  # a crashed machine is resumed, not finished
                MIGRATIONS_TOTAL.inc(phase=final_phase,
                                     outcome=journal.get("outcome") or "failed")
                # the terminal record, a machine adopted after a crash too
                # (invariant 6), with each phase's wall time
                src = journal["source"]
                AUDIT.record(
                    "migrate", actor="orchestrator", namespace=src["namespace"],
                    pod=src["pod"], chips=journal.get("chips"),
                    outcome=journal.get("outcome") or "failed",
                    duration_s=time.time() - journal.get("created_at", 0.0), id=mid,
                    phases=dict(journal.get("phase_durations_s") or {}),
                    downtime_s=journal.get("downtime_s"),
                    checkpoint=bool(journal.get("checkpoint")),
                    destination=f"{journal['destination']['namespace']}/"
                                f"{journal['destination']['pod']}")
            with self._lock:
                self._aborts.discard(mid)
                self._threads.pop(mid, None)

    def _await_api_healthy(self, journal: dict) -> None:
        """Hold the machine at this phase boundary (its last journaled
        transition, from which every phase can run again) until the API is
        healthy. The pause is journaled (the write defers into the store's
        queue), so a master's crash in the outage resumes from here, and
        /migrations shows paused_for_api. An abort in an abortable phase ends
        the wait."""
        if self.apihealth is None or self.apihealth.ok():
            return
        mid = journal["id"]
        logger.warning("migration %s pausing at phase boundary %r: api %s", mid,
                       journal["phase"], self.apihealth.state())
        journal["paused_for_api"] = True
        try:
            self._persist(journal)
        except Exception as exc:  # noqa: BLE001 — the pause must not kill the
            # machine; the memory's copy records it
            logger.warning("pause journal persist failed: %s", exc)
        while not self.apihealth.ok():
            if mid in self._aborts and journal["phase"] in self.ABORTABLE_PHASES:
                return
            time.sleep(self.cfg.migrate_poll_interval_s)
        journal.pop("paused_for_api", None)
        logger.info("migration %s resuming from phase %r: api healthy", mid, journal["phase"])
        self._persist(journal)

    # --- the phases (each re-entrant after a master's crash) ---

    def _signal(self, ref: dict, journal: dict, phase: str, **extra) -> None:
        """The tenant-facing stamp of `phase`, with the migration's trace:
        the tenant's telemetry stamps it on the disruption window it opens,
        so its downtime joins /trace/<id> and the audit trail."""
        self._stamp(ref, ANNOT_PHASE, {"id": journal["id"], "phase": phase,
                                       "trace_id": journal.get("trace_id", ""), **extra})

    def _phase_quiesce(self, journal: dict) -> str:
        src = journal["source"]
        self._signal(src, journal, "quiesce", destination=journal["destination"])
        journal["quiesced"] = self._await_ack(src, journal["id"], "quiesced",
                                              self.cfg.migrate_quiesce_timeout_s,
                                              abortable=True)
        if not journal["quiesced"]:
            logger.warning("migration %s: no quiesce ack from %s/%s within %.0fs; draining "
                           "anyway (tenant loses the warm pack/restore path, not the chips' "
                           "state on disk)", journal["id"], src["namespace"], src["pod"],
                           self.cfg.migrate_quiesce_timeout_s)
        return "checkpoint" if journal.get("checkpoint") else "drain"

    def _phase_checkpoint(self, journal: dict) -> str:
        """Wait for the tenant's ack that its pack is saved on the host,
        before any GPU is drained; the destination then restores from it. A
        tenant without the hook times out and is cold-restored, as a missed
        quiesce ack is."""
        src = journal["source"]
        self._signal(src, journal, "checkpoint", destination=journal["destination"])
        journal["checkpointed"] = self._await_ack(src, journal["id"], "checkpointed",
                                                  self.cfg.migrate_checkpoint_timeout_s,
                                                  abortable=True)
        if not journal["checkpointed"]:
            logger.warning("migration %s: no checkpoint ack from %s/%s within %.0fs; draining "
                           "anyway (the destination tenant will cold-restore instead of "
                           "copying the packed state)", journal["id"], src["namespace"],
                           src["pod"], self.cfg.migrate_checkpoint_timeout_s)
        return "drain"

    def _phase_drain(self, journal: dict) -> str:
        src = journal["source"]
        address = self._worker_addr(src["namespace"], src["pod"])
        held = [c.uuid for c in self._probe(address, src["namespace"], src["pod"])]
        if not journal["chips"]:
            if not held:
                raise MigrationError(f"source {src['namespace']}/{src['pod']} holds no chips "
                                     f"at drain time")
            journal["chips"] = sorted(held)
        if journal["downtime_started_at"] is None:
            journal["downtime_started_at"] = time.time()
        # the set and the clock are journaled before any removal: a crash
        # between the remove and the next persist must not forget what the
        # source held
        self._persist(journal)
        to_remove = [u for u in journal["chips"] if u in set(held)]
        if to_remove:
            with self.client_factory(address) as client:
                result = client.remove_gpu(
                    src["pod"], src["namespace"], to_remove, force=True,
                    **self._node_epoch(src["namespace"], src["pod"])).remove_gpu_result
            if result not in (api.RemoveGPUResult.Success, api.RemoveGPUResult.GPUNotFound):
                raise MigrationError(f"drain of {len(to_remove)} chip(s) returned "
                                     f"{api.RemoveGPUResult(result).name}")
        return "remount"

    def _mount(self, ref: dict, count: int) -> None:
        """`count` GPUs into `ref`'s pod through the slice coordinator's
        all-or-nothing path (its rollback covers a set of several)."""
        from gpumounter_tpu_torch.master.slice_ops import SliceCoordinator, SliceTarget
        SliceCoordinator(self.kube, self.registry, self.client_factory, self.cfg,
                         shards=self.shards).mount_slice(
            [SliceTarget(namespace=ref["namespace"], pod=ref["pod"])], count, entire=False)

    def _phase_remount(self, journal: dict) -> str:
        from gpumounter_tpu_torch.master.slice_ops import SliceError
        dst = journal["destination"]
        address = self._worker_addr(dst["namespace"], dst["pod"])
        want = len(journal["chips"])
        if journal["dest_before"] is None:
            journal["dest_before"] = sorted(
                c.uuid for c in self._probe(address, dst["namespace"], dst["pod"]))
            self._persist(journal)
        current = {c.uuid for c in self._probe(address, dst["namespace"], dst["pod"])}
        moved = sorted(current - set(journal["dest_before"]))
        if not moved:
            try:
                self._mount(dst, want)
            except SliceError as exc:
                raise MigrationError(f"re-mount of {want} chip(s) on "
                                     f"{dst['namespace']}/{dst['pod']} failed: {exc}",
                                     exc.status)
            current = {c.uuid for c in self._probe(address, dst["namespace"], dst["pod"])}
            moved = sorted(current - set(journal["dest_before"]))
        if len(moved) != want:
            raise MigrationError(f"destination gained {len(moved)} chip(s), expected {want} "
                                 f"({moved})")
        journal["dest_chips"] = moved
        return "resume"

    def _phase_resume(self, journal: dict) -> str:
        dst = journal["destination"]
        # the destination restores from the pack only when its save was
        # acked (the checkpoint); else it rebuilds its state cold
        self._signal(dst, journal, "resume", checkpointed=bool(journal.get("checkpointed")),
                     chips=journal["dest_chips"], source=journal["source"])
        signaled_at = time.time()
        journal["resumed"] = self._await_ack(dst, journal["id"], "resumed",
                                             self.cfg.migrate_resume_timeout_s)
        if journal["downtime_started_at"] is not None and journal["downtime_s"] is None:
            # acked: the window closes now; no ack (a tenant without the
            # hook): at the signal, since the GPUs were usable from the stamp
            # and the ack's timeout must not inflate the downtime
            closed_at = time.time() if journal["resumed"] else signaled_at
            journal["downtime_s"] = round(closed_at - journal["downtime_started_at"], 3)
            MIGRATION_DOWNTIME.observe(journal["downtime_s"])
        return "verify"

    def _phase_verify(self, journal: dict) -> str:
        dst = journal["destination"]
        address = self._worker_addr(dst["namespace"], dst["pod"])
        by_uuid = {c.uuid: c for c in self._probe(address, dst["namespace"], dst["pod"])}
        bad = [u for u in journal["dest_chips"] if u not in by_uuid or not by_uuid[u].healthy]
        if bad:
            raise MigrationError(f"verify failed: moved chip(s) missing/unhealthy on "
                                 f"{dst['namespace']}/{dst['pod']}: {bad}")
        journal["outcome"] = "succeeded"
        self._transfer_intent(journal)
        self._stamp(journal["source"], ANNOT_PHASE, {"id": journal["id"], "phase": "done"})
        self._clear_lock(journal)
        src_pod = self._try_pod(journal["source"])
        if src_pod is not None:
            post_pod_event(self.kube, src_pod, SUCCEEDED_REASON,
                           f"migration {journal['id']}: {len(journal['dest_chips'])} chip(s) now "
                           f"on {dst['namespace']}/{dst['pod']} (downtime "
                           f"{journal['downtime_s']}s)", component="tpumounter-migrate")
        return PHASE_DONE

    def _transfer_intent(self, journal: dict) -> None:
        """The elastic intent follows the tenant: left on the source, the
        reconciler would mount fresh GPUs there the moment the pause lifts,
        undoing the move. A failure leaves a double intent, never a failed
        migration."""
        from gpumounter_tpu_torch.elastic.intents import (
            ANNOT_DESIRED,
            ANNOT_MIN,
            ANNOT_PRIORITY,
            Intent,
            IntentError,
        )
        src, dst = journal["source"], journal["destination"]
        src_pod = self._try_pod(src)
        if src_pod is None:
            return
        try:
            intent = Intent.from_annotations(src_pod.annotations)
        except IntentError:
            intent = None
        if intent is None:
            return
        try:
            dst_pod = self._try_pod(dst)
            if dst_pod is None or ANNOT_DESIRED not in dst_pod.annotations:
                # a destination's own intent wins
                self.kube.patch_pod(dst["namespace"], dst["pod"],
                                    {"metadata": {"annotations": intent.to_annotations()}})
            self.kube.patch_pod(src["namespace"], src["pod"], {"metadata": {"annotations": {
                ANNOT_DESIRED: None, ANNOT_MIN: None, ANNOT_PRIORITY: None}}})
            logger.info("migration %s: moved elastic intent (desired=%d) from %s/%s to %s/%s",
                        journal["id"], intent.desired_chips, src["namespace"], src["pod"],
                        dst["namespace"], dst["pod"])
        except Exception as exc:  # noqa: BLE001 — advisory: an outage heals by
            # the next reconcile, a refusal needs a human
            logger.warning("intent transfer for migration %s failed (%s): %s", journal["id"],
                           "api outage" if is_outage(exc) else "api error", exc)

    # --- the rollback ---

    def _rollback(self, journal: dict, reason: str, outcome: str = "rolled-back") -> None:
        logger.error("migration %s rolling back (%s): %s", journal["id"], outcome, reason)
        src, dst = journal["source"], journal["destination"]
        want = len(journal["chips"])
        failure: str | None = None

        # 1. reclaim what landed on the destination; without a journaled set
        # (a crash between the mount and its persist, a count mismatch) the
        # live diff against the set before the remount
        try:
            cleanup = list(journal.get("dest_chips") or [])
            if not cleanup and journal.get("dest_before") is not None:
                address = self._worker_addr(dst["namespace"], dst["pod"])
                current = {c.uuid for c in self._probe(address, dst["namespace"], dst["pod"])}
                cleanup = sorted(current - set(journal["dest_before"]))
            if cleanup:
                address = self._worker_addr(dst["namespace"], dst["pod"])
                with self.client_factory(address) as client:
                    client.remove_gpu(dst["pod"], dst["namespace"], cleanup, force=True,
                                      **self._node_epoch(dst["namespace"], dst["pod"]))
        except Exception as exc:  # noqa: BLE001 — go on restoring
            failure = f"destination cleanup failed: {exc}"

        # 2. the source's count, again
        try:
            if want:
                address = self._worker_addr(src["namespace"], src["pod"])
                missing = want - len(self._probe(address, src["namespace"], src["pod"]))
                if missing > 0:
                    self._mount(src, missing)
        except Exception as exc:  # noqa: BLE001 — still unfreeze below
            failure = failure or f"source restore failed: {exc}"

        # 3. ALWAYS signal the source's tenant "resume", even when the
        # restore failed or nothing was drained: a tenant paused on the
        # quiesce must not stay frozen. The signal names the GPUs the source
        # holds now (the restore mounts fresh ones); the old set if the probe
        # fails
        try:
            chips_now = list(journal["chips"])
            try:
                address = self._worker_addr(src["namespace"], src["pod"])
                chips_now = sorted(c.uuid for c in
                                   self._probe(address, src["namespace"], src["pod"]))
            except Exception:  # noqa: BLE001 — the old set
                pass
            self._signal(src, journal, "resume", chips=chips_now)
        except Exception as exc:  # noqa: BLE001 — recorded, not fatal
            failure = failure or f"source resume signal failed: {exc}"

        # 4. the source whole again?
        try:
            if want:
                address = self._worker_addr(src["namespace"], src["pod"])
                healthy = [c for c in self._probe(address, src["namespace"], src["pod"])
                           if c.healthy]
                journal["rollback_healthy"] = len(healthy)
                if len(healthy) < want:
                    failure = failure or (f"source restored with only {len(healthy)}/{want} "
                                          f"healthy chip(s)")
        except Exception as exc:  # noqa: BLE001 — recorded, not fatal
            failure = failure or str(exc)
        journal["outcome"] = outcome if failure is None else "failed"
        journal["error"] = reason if failure is None \
            else f"{reason}; rollback incomplete: {failure}"
        journal["phase"] = PHASE_DONE
        self._clear_lock(journal)
        try:
            self._persist(journal)
        except Exception as exc:  # noqa: BLE001 — the source may be gone
            logger.warning("terminal journal persist failed: %s", exc)
            with self._lock:  # the memory's copy stands
                self._journals[journal["id"]] = copy.deepcopy(journal)
        src_pod = self._try_pod(src)
        if src_pod is not None:
            post_pod_event(self.kube, src_pod, ROLLED_BACK_REASON,
                           f"migration {journal['id']} {journal['outcome']}: {journal['error']}",
                           event_type="Warning", component="tpumounter-migrate")

    # --- plumbing ---

    def _scan(self) -> list[dict]:
        """The store's journals; in an outage that even the store's cache
        cannot answer, the memory's view (so /migrations answers, and
        resume_interrupted adopts nothing until the heal)."""
        try:
            return self.store.scan_journals()
        except Exception as exc:  # noqa: BLE001 — the outage's boundary
            if not is_outage(exc):
                raise
            logger.warning("migration journal scan degraded to the in-memory view: %s", exc)
            with self._lock:
                return [copy.deepcopy(j) for j in self._journals.values()]

    def _persist(self, journal: dict) -> None:
        src = journal["source"]
        # the crash site between a phase's end and its journal write: the
        # lost update, which the phases' re-entry covers
        failpoints.fire("migrate.persist", id=journal["id"], phase=journal["phase"])
        try:
            with trace.span("migrate.journal_persist", id=journal["id"],
                            phase=journal["phase"]):
                self.store.save_journal(journal)
        except NotFoundError:
            raise MigrationError(f"source pod {src['namespace']}/{src['pod']} disappeared "
                                 f"mid-migration")
        with self._lock:
            self._journals[journal["id"]] = copy.deepcopy(journal)

    def _stamp(self, ref: dict, annotation: str, payload: dict) -> None:
        payload = {**payload, "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        try:
            self.store.stamp_annotation(ref["namespace"], ref["pod"], annotation,
                                        json.dumps(payload))
        except NotFoundError:
            logger.warning("cannot stamp %s on %s/%s: pod gone", annotation, ref["namespace"],
                           ref["pod"])

    def _clear_lock(self, journal: dict) -> None:
        dst = journal["destination"]
        # the store retries a 409 or a 5xx; this covers a transport failure
        # with no status, before the stale-lock check of migration_active
        # has to
        for attempt in range(3):
            try:
                self.store.stamp_annotation(dst["namespace"], dst["pod"], ANNOT_LOCK, None)
                return
            except NotFoundError:
                return
            except Exception as exc:  # noqa: BLE001 — retried
                logger.warning("lock clear on %s/%s failed (try %d): %s", dst["namespace"],
                               dst["pod"], attempt + 1, exc)
                time.sleep(0.2)

    def _await_ack(self, ref: dict, mid: str, phase: str, timeout_s: float,
                   abortable: bool = False) -> bool:
        """Poll the worker's QuiesceStatus until the tenant acks `phase` of
        this migration, the timeout passes, or (abortable phases only) an
        abort lands."""
        address = self._worker_addr(ref["namespace"], ref["pod"])
        deadline = time.monotonic() + timeout_s
        # one client for the whole wait, not a dial a poll
        with self.client_factory(address) as client:
            while time.monotonic() < deadline:
                if abortable and mid in self._aborts:
                    # only before anything moved: the resume's wait runs on,
                    # since a late abort must not fake a silent tenant
                    return False
                try:
                    result, status = client.quiesce_status(ref["pod"], ref["namespace"])
                except Exception as exc:  # noqa: BLE001 — polled again
                    logger.warning("quiesce-status poll failed: %s", exc)
                    time.sleep(self.cfg.migrate_poll_interval_s)
                    continue
                if result == api.QuiesceStatusResult.Success and status.acked_id == mid \
                        and status.acked_phase == phase:
                    return True
                time.sleep(self.cfg.migrate_poll_interval_s)
        return False

    def _get_pod_checked(self, namespace: str, pod_name: str) -> Pod:
        try:
            return Pod(self.kube.get_pod(namespace, pod_name))
        except NotFoundError:
            raise MigrationRejected(f"No pod: {pod_name} in namespace: {namespace}", 404)

    def _try_pod(self, ref: dict) -> Pod | None:
        try:
            return Pod(self.kube.get_pod(ref["namespace"], ref["pod"]))
        except NotFoundError:
            return None
        except Exception as exc:  # noqa: BLE001 — an Event's target is best effort
            if is_outage(exc):
                logger.debug("pod lookup for event target %s/%s lost to api outage: %s",
                             ref["namespace"], ref["pod"], exc)
            return None

    def _worker_addr(self, namespace: str, pod_name: str) -> str:
        pod = self._get_pod_checked(namespace, pod_name)
        if not pod.node_name:
            raise MigrationRejected(f"Pod {pod_name} is not scheduled yet", 400)
        address = self.registry.worker_address(pod.node_name)
        if address is None:
            raise MigrationError(f"no gpu-mounter worker on node {pod.node_name}", 503)
        return address

    def _probe(self, address: str, namespace: str, pod_name: str) -> list[api.ChipHealth]:
        try:
            with self.client_factory(address) as client:
                result, chips = client.probe_gpu(pod_name, namespace)
        except Exception as exc:  # noqa: BLE001 — the worker call's boundary
            raise MigrationError(f"probe RPC failed: {exc}")
        if result != api.ProbeGPUResult.Success:
            raise MigrationError(f"probe of {namespace}/{pod_name} returned {result.name}")
        return chips
