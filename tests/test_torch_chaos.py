"""The port's base chaos harness (``gpumounter_tpu_torch/testing/chaos.py``).

The counterparts of ``tests/test_chaos.py``'s controls run on both
packages' harnesses, and what each found must be the same: the disabled
rollback is detected (an ownerless grant, with the seed in the message), the
slice's admission failpoint fails clean, and the skipped slice rollback
leaves one host's GPU mounted and booked. Then the port's seeded mount
scenario at three seeds, whose invariants 1-3, 5 and 6 must hold (its pool
holds the reference's crash terms, converged by the ledger's replay), and the
reproducibility of its schedule.
"""

from __future__ import annotations

import pytest
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.master.slice_ops import SliceError as RefSliceError
from gpumounter_tpu.master.slice_ops import SliceTarget as RefTarget
from gpumounter_tpu.testing import chaos as ref_chaos
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.master.slice_ops import SliceError, SliceTarget
from gpumounter_tpu_torch.testing import chaos
from gpumounter_tpu_torch.testing.chaos import NODE_A, NODE_B, ChaosHarness, InvariantViolation

SEEDS = [7, 1337, 20260803]

#: (harness module, failpoints, SliceTarget, SliceError, the mount coordinator)
SIDES = {
    "reference": (ref_chaos, ref_failpoints, RefTarget, RefSliceError,
                  lambda h: h._coordinator()),
    "port": (chaos, failpoints, SliceTarget, SliceError, lambda h: h.coordinator()),
}


def _control(name, root, seed, pods, schedule, n):
    """Arm `schedule`, mount a slice of `n` single mounts into `pods`; what
    the mount raised, the pods holding a GPU after, and the invariants'
    verdict (their first violation's kind)."""
    mod, fp, target, slice_error, coordinator = SIDES[name]
    with mod.ChaosHarness(root, seed=seed) as h:
        for pod, node in pods:
            h.add_pod(pod, node)
        armed = {k.replace("addgpu", "addtpu") if name == "reference" else k: v
                 for k, v in schedule.items()}
        raised = None
        with fp.armed(armed):
            try:
                coordinator(h).mount_slice([target(namespace="default", pod=p) for p, _ in pods],
                                           n, entire=False)
            except (slice_error, fp.FailpointError) as exc:
                raised = type(exc).__name__
        held = h.held_chips() if name == "reference" else h.held_gpus()
        try:
            h.check_invariants()
            verdict = "held"
        except mod.InvariantViolation as exc:
            message = str(exc)
            verdict = (message.split("\n- ")[1].split(":")[0], f"seed={seed}" in message)
    return raised, sorted(p for (_, p), uuids in held.items() if uuids), verdict


CONTROLS = {
    "the disabled rollback is detected": (
        [("victim", NODE_A)], {"worker.addgpu.rollback.skip": "return(true)",
                               "worker.mount.mknod": "1*pass->1*error(chaos mknod)"}, 2,
        ("SliceError", ["victim"], ("ownerless grant", True))),
    "the slice's admission failpoint fails clean": (
        [("adm", NODE_A)], {"master.slice.mount": "1*error(chaos admission)"}, 1,
        ("FailpointError", [], "held")),
    "the skipped slice rollback leaves one host mounted": (
        [("sl-a", NODE_A), ("sl-b", NODE_B)],
        {"master.slice.rollback.skip": "return(true)",
         "worker.mount.mknod": "1*pass->1*error(chaos mknod)"}, 1,
        None),
}


@pytest.mark.parametrize("case", list(CONTROLS))
def test_a_control_ends_as_the_references(tmp_path, case):
    pods, schedule, n, want = CONTROLS[case]
    got = {name: _control(name, str(tmp_path / name), 1 + list(CONTROLS).index(case), pods,
                          schedule, n) for name in SIDES}
    if want is None:  # which host fails its mknod is a race: one of the two survives
        for raised, survivors, verdict in got.values():
            assert (raised, len(survivors), verdict) == ("SliceError", 1, "held")
    else:
        assert got["port"] == got["reference"] == want


@pytest.mark.parametrize("seed", SEEDS)
def test_mount_chaos(tmp_path, seed):
    with ChaosHarness(str(tmp_path), seed) as h:
        h.run_mount_scenario(n_ops=8)
        h.check_invariants()
        assert any(line.startswith("arm ") for line in h.schedule), h.schedule


def test_the_schedule_replays_from_its_seed(tmp_path):
    def decisions(root):
        with ChaosHarness(root, 42) as h:
            h.run_mount_scenario(n_ops=6)
            return [line for line in h.schedule if line.startswith("arm ")]

    assert decisions(str(tmp_path / "a")) == decisions(str(tmp_path / "b"))


def test_the_pool_is_the_references_without_its_crash_terms():
    """The pool was the reference's less its two crash terms until the
    ledger's replay came to converge what they leave; now it is the
    reference's whole, and without its crash terms it is that pool still."""
    assert chaos.FAULTS_COMMON == ref_chaos.FAULTS_COMMON
    crash = [f for f in chaos.FAULTS_COMMON if "crash" in f[1]]
    assert [name for name, _ in crash] == ["worker.mount.before_grant",
                                           "worker.mount.after_grant"]
    assert [f for f in chaos.FAULTS_COMMON if f not in crash] == \
        [f for f in ref_chaos.FAULTS_COMMON if "crash" not in f[1]]


def test_an_open_span_and_a_traceless_record_are_violations(tmp_path):
    """Invariants 5 and 6 have teeth: a span left open and an audit record
    with no outcome and no trace id are each named, with the seed."""
    from gpumounter_tpu_torch.obs import audit, trace
    with ChaosHarness(str(tmp_path), seed=5) as h:
        trace.TRACER._open_add("dangling", "never.closed")
        audit.AUDIT.record("bare.op", trace_id="")
        with pytest.raises(InvariantViolation) as err:
            h.check_invariants()
    message = str(err.value)
    assert "seed=5" in message and "never.closed" in message
    assert "audit record without outcome" in message and "without trace id" in message
