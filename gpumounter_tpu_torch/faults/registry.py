"""Declared failpoint sites of the port.

The counterpart of ``gpumounter_tpu/faults/registry.py``. Every
``failpoints.fire(...)`` / ``failpoints.value(...)`` site name in
``gpumounter_tpu_torch/`` is declared here exactly once, and every declared
name has a site and is armed by at least one test
(``tests/test_torch_failpoints.py`` holds both rules, as the reference's
tpulint rule ``failpoint-registry`` does). Sites built with f-strings are
covered by DYNAMIC_PREFIXES; their arm specs carry the concrete suffix
(``k8s.patch_pod.status``).

The names are the reference's, every one of its sites among them, but for
one: ``worker.addtpu.rollback.skip`` is ``worker.addgpu.rollback.skip``.

This module is data: the runtime (``faults/failpoints.py``) does not read
it, so an undeclared point still arms in a dev loop.
"""

from __future__ import annotations

FAILPOINTS: dict[str, str] = {
    # elastic reconciler (elastic/reconciler.py)
    "elastic.reconcile": "top of one reconcile pass for a keyed intent",
    "elastic.before_grow": "after the dead GPUs' removal, before the grow "
                           "mounts fire",
    # slice coordinator (master/slice_ops.py)
    "master.slice.mount": "per-slice mount, before the pods are resolved",
    "master.slice.rollback.skip": "value(): skip the slice rollback (leak "
                                  "simulation for the chaos harness)",
    # migration machine (migrate/orchestrator.py)
    "migrate.persist": "before a journal annotation persist",
    # defragmenter (defrag/controller.py)
    "defrag.run": "top of a defrag plan execution, before the first "
                  "barrier sample",
    # autoscaler (autoscale/controller.py)
    "autoscale.pass": "top of one evaluate pass, before any tenant is "
                      "considered",
    # rpc client (rpc/client.py)
    "rpc.client.call": "before every outbound worker RPC attempt",
    "rpc.client.deadline": "value(): per-call deadline override",
    # worker (worker/server.py, worker/mounter.py)
    "worker.rpc": "top of every worker RPC handler (method= ctx)",
    "worker.mount.before_grant": "mount batch: before the cgroup grant",
    "worker.mount.after_grant": "mount batch: grant done, nodes not yet "
                                "injected",
    "worker.mount.mknod": "per-GPU, before the batch's one namespace entry",
    "worker.mount.rollback": "per-cgroup grant undo during rollback",
    "worker.addgpu.rollback.skip": "value(): skip mount rollback (leak "
                                   "simulation)",
    "worker.unmount.before_revoke": "unmount batch: before the cgroup "
                                    "revoke",
    # warm pool (allocator/pool.py)
    "pool.refill": "per-node warm-pool refill attempt",
    # health plane (health/plane.py)
    "health.observe": "top of one gray-failure scoring pass (nodes= "
                      "ctx); armed with pdrop/pdelay by the gray chaos "
                      "scenario",
    "health.canary": "canary probe, before the synthetic mount dials "
                     "the worker (node= ctx)",
}

#: f-string site families: a name starting with one of these prefixes is
#: declared by the prefix (the suffix is data: a Kubernetes verb, a
#: migration's phase).
DYNAMIC_PREFIXES: frozenset[str] = frozenset({
    "k8s.",            # k8s/client.py: k8s.<op> and k8s.<op>.status
    "migrate.phase.",  # migrate/orchestrator.py: migrate.phase.<phase>
})
