"""The userspace policy engine (``cgroup/policy.py``) against the
reference's, and against the interpreter over the kernel's program.

The same seeded op sequence (set, admit, refill, clear, drop) runs on the
port's ``UserspacePolicyEngine`` and the reference's: every answer, every
table and the throttle counters must be equal. Then the engine is held to
the in-kernel procedure: the engine's entries are the policy map of a
device program, and each admit through the engine must agree with the
interpreter's verdict on an rw access (a miss falls to the static rules),
with the same entries left after. An engine that does not enforce must
disagree.
"""

from __future__ import annotations

import numpy as np
import pytest

from gpumounter_tpu.cgroup import ebpf as ref_ebpf
from gpumounter_tpu.cgroup import policy as ref_policy
from gpumounter_tpu_torch.cgroup import ebpf, policy

SCOPES = ("ml/trainer", "ml/server")
GPUS = [(195, m) for m in range(4)]
RW = ebpf.BPF_DEVCG_ACC_READ | ebpf.BPF_DEVCG_ACC_WRITE
POLICY_FD = 9


@pytest.fixture(autouse=True)
def _fresh_counters():
    for mod in (policy, ref_policy):
        mod.THROTTLES.reset()
    yield
    for mod in (policy, ref_policy):
        mod.THROTTLES.reset()


def _ops(seed: int, n: int = 200) -> list[tuple]:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = str(rng.choice(["set", "admit", "admit", "admit", "refill", "clear", "drop"],
                              p=[0.2, 0.2, 0.2, 0.2, 0.1, 0.07, 0.03]))
        scope = str(rng.choice(SCOPES))
        major, minor = GPUS[int(rng.integers(len(GPUS)))]
        tokens = (ebpf.POLICY_UNMETERED if rng.random() < 0.3
                  else int(rng.integers(0, 6)))
        ops.append((kind, scope, major, minor, int(rng.integers(0, 1 << 16)), tokens))
    return ops


def _apply(engine, op):
    kind, scope, major, minor, weight, tokens = op
    if kind == "set":
        return engine.set_policy(scope, major, minor, weight, tokens)
    if kind == "admit":
        return engine.admit(scope, major, minor)
    if kind == "refill":
        return engine.refill(scope, major, minor, tokens)
    if kind == "clear":
        return engine.clear_policy(scope, major, minor)
    return engine.drop_scope(scope)


@pytest.mark.parametrize("seed", range(8))
def test_engines_agree_op_by_op(seed):
    port, ref = policy.UserspacePolicyEngine(), ref_policy.UserspacePolicyEngine()
    answers = []
    for op in _ops(seed):
        got, want = _apply(port, op), _apply(ref, op)
        assert got == want, op
        assert sorted(port.scopes()) == sorted(ref.scopes())
        assert {s: port.entries(s) for s in SCOPES} == {s: ref.entries(s) for s in SCOPES}
        answers.append(got)
    assert policy.THROTTLES.get() == ref_policy.THROTTLES.get() == answers.count(False)
    assert answers.count(False) and answers.count(True) and answers.count(None)
    port.reset()
    assert port.scopes() == []


def _kernel_admit(prog: bytes, table: dict[int, int], major: int, minor: int) -> int:
    maps = {POLICY_FD: table}
    return policy.interpret_device_program(prog, maps, ebpf.BPF_DEVCG_DEV_CHAR, RW, major, minor)


@pytest.mark.parametrize("seed", range(4))
def test_engine_agrees_with_the_program(seed):
    """On one scope: each admit through the engine against the program
    over a map holding the engine's entries; a miss is the static rules'
    answer (the defaults deny rw on a GPU), a throttled entry a deny, and
    a metered one takes a token on both sides."""
    engine = policy.UserspacePolicyEngine()
    prog = ebpf.build_device_program(ebpf.DEFAULT_CONTAINER_RULES, policy_map_fd=POLICY_FD)
    assert prog == ref_ebpf.build_device_program(ref_ebpf.DEFAULT_CONTAINER_RULES,
                                                 policy_map_fd=POLICY_FD)
    table: dict[int, int] = {}
    decided = []
    spend = [("set", "", 195, 3, 7, 1)] + [("admit", "", 195, 3, 0, 0)] * 2
    for kind, _, major, minor, weight, tokens in _ops(100 + seed, 150) + spend:
        op = (kind, SCOPES[0], major, minor, weight, tokens)
        if kind != "admit":
            _apply(engine, op)
            table = engine.entries(SCOPES[0])
            continue
        answer = engine.admit(SCOPES[0], major, minor)
        verdict = _kernel_admit(prog, table, major, minor)
        assert verdict == (0 if answer is None else int(answer)), op
        assert table == engine.entries(SCOPES[0])
        decided.append(answer)
    assert {None, True, False} <= set(decided)


def test_an_engine_that_does_not_enforce_diverges():
    """The negative control: with enforcement off, a spent budget still
    admits, where the program denies."""
    prog = ebpf.build_device_program(ebpf.DEFAULT_CONTAINER_RULES, policy_map_fd=POLICY_FD)
    for enforce, want in ((True, False), (False, True)):
        engine = policy.UserspacePolicyEngine(enforce=enforce)
        engine.set_policy(SCOPES[0], 195, 0, weight=10, tokens=1)
        assert engine.admit(SCOPES[0], 195, 0) is True
        table = {ebpf.telemetry_key(195, 0): ebpf.policy_value(10, 0)}
        assert engine.entries(SCOPES[0]) == table
        assert engine.admit(SCOPES[0], 195, 0) is want
        assert _kernel_admit(prog, table, 195, 0) == 0
    assert policy.THROTTLES.get() == 1


def test_refill_keeps_the_weight_and_a_cleared_scope_goes():
    for mod in (policy, ref_policy):
        engine = mod.UserspacePolicyEngine()
        engine.set_policy("s", 195, 1, weight=70, tokens=0)
        engine.refill("s", 195, 1, 5)
        engine.refill("s", 195, 2, 5)  # no entry: nothing to refill
        assert engine.entries("s") == {ebpf.telemetry_key(195, 1): ebpf.policy_value(70, 5)}
        engine.clear_policy("s", 195, 1)
        assert engine.scopes() == [] and engine.entries("s") == {}
