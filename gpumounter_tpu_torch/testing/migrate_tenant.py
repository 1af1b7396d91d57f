"""A tenant that rides a live migration: the two ends of a move.

The source's tenant builds the probe model (``models/probe.py``) from a seed
on its device, runs one forward over seeded tokens (through ``flash_fwd`` on
the card), and watches its pod's migration signal
(``torchside.watch_migration``): on the quiesce it packs its parameters
with ``HotResumable``, on the checkpoint it saves the pack to `pack_dir`,
and each is acked (``tpumounter.io/migration-ack``, which the machine reads
through the worker's QuiesceStatus). It ends once its checkpoint ack is on
the pod. The destination's tenant watches its own pod: on the resume it
loads the pack, restores it onto its device (its ack says it restored),
and runs the same forward. Both report the sha256 of their logits' bytes,
so a restore that is exact shows as equal hashes.

``run(kube, spec, device)`` runs one end in this process (the CPU check
runs both in threads over the in-process fake API). ``python -m
gpumounter_tpu_torch.testing.migrate_tenant '<spec>'`` runs one end as a
process on the card, its API a ``RestKubeClient`` to the stand-in API
server, and prints one JSON line. The spec: {"role": "source" or
"destination", "namespace", "pod", "pack_dir", "model": the
``TransformerConfig`` fields, "tokens": [B, L], "seed", "timeout_s",
"api": {"port", "token", "ca"} for a process}.
"""

from __future__ import annotations

import hashlib
import json
import sys
import threading
import time

import numpy as np
import torch

from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.migrate.journal import ANNOT_ACK
from gpumounter_tpu_torch.models.probe import (
    TransformerConfig,
    forward,
    init_params,
    next_token_nll,
)
from gpumounter_tpu_torch.ops.flash_attention import flash_attention_kernel
from gpumounter_tpu_torch.torchside import HotResumable
from gpumounter_tpu_torch.torchside.migrate import watch_migration


def _forward(params: dict, cfg: TransformerConfig, spec: dict, device) -> dict:
    """The seeded forward: its logits' sha256, NLL, finiteness, shape,
    flash_fwd launches and ms (host clock, synchronized)."""
    b, length = spec["tokens"]
    rng = np.random.default_rng(spec["seed"])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, length))).to(device)
    launches0 = flash_attention_kernel.launches
    t0 = time.perf_counter()
    logits = forward(params, tokens, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention_kernel.launches - launches0
    host = logits.detach().cpu().contiguous()
    return {"sha256": hashlib.sha256(host.numpy().tobytes()).hexdigest(),
            "nll": next_token_nll(logits, tokens).item(),
            "finite": bool(torch.isfinite(host).all()), "shape": list(host.shape),
            "launches": launches, "forward_ms": ms}


def _acked(kube, namespace: str, pod: str, phase: str) -> bool:
    raw = Pod(kube.get_pod(namespace, pod)).annotations.get(ANNOT_ACK)
    try:
        return bool(raw) and json.loads(raw).get("phase") == phase
    except ValueError:
        return False


def run(kube, spec: dict, device) -> dict:
    """One end of the move (`spec["role"]`), until its work is done or
    `spec["timeout_s"]` passes (then it raises). Returns its report."""
    device = torch.device(device)
    cfg = TransformerConfig(**spec["model"])
    namespace, pod, role = spec["namespace"], spec["pod"], spec["role"]
    deadline = time.monotonic() + spec["timeout_s"]
    stop, done = threading.Event(), threading.Event()
    report: dict = {"role": role, "pod": f"{namespace}/{pod}", "signals": []}
    state: dict = {}

    if role == "source":
        state["params"] = init_params(cfg, torch.Generator().manual_seed(spec["seed"]), device)
        report.update(_forward(state["params"], cfg, spec, device))

        def on_quiesce(signal: dict) -> None:
            report["signals"].append(signal.get("phase"))
            t0 = time.perf_counter()
            state["pack"] = HotResumable.pack(state["params"])
            report["pack_ms"] = (time.perf_counter() - t0) * 1e3
            report["trace_id"] = signal.get("trace_id", "")

        def on_checkpoint(signal: dict) -> None:
            report["signals"].append(signal.get("phase"))
            t0 = time.perf_counter()
            state["pack"].save(spec["pack_dir"])
            report["save_ms"] = (time.perf_counter() - t0) * 1e3
            done.set()

        callbacks = dict(on_quiesce=on_quiesce, on_checkpoint=on_checkpoint)
    elif role == "destination":
        def on_quiesce(signal: dict) -> None:
            report["signals"].append(signal.get("phase"))

        def on_resume(signal: dict) -> None:
            report["signals"].append(signal.get("phase"))
            report["checkpointed"] = bool(signal.get("checkpointed"))
            report["chips"] = list(signal.get("chips") or [])
            t0 = time.perf_counter()
            pack = HotResumable.load(spec["pack_dir"])
            report["load_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            (state["params"],) = pack.restore(device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            report["restore_ms"] = (time.perf_counter() - t0) * 1e3
            done.set()

        callbacks = dict(on_quiesce=on_quiesce, on_resume=on_resume)
    else:
        raise ValueError(f"role {role!r}: source or destination")

    watcher = threading.Thread(target=watch_migration, args=(kube, namespace, pod),
                               kwargs=dict(stop=stop, watch_timeout_s=1.0, **callbacks),
                               daemon=True)
    watcher.start()
    report["ready_at"] = time.time()
    if spec.get("on_ready") is not None:
        spec["on_ready"](report)
    try:
        if not done.wait(max(0.0, deadline - time.monotonic())):
            raise TimeoutError(f"the {role}'s tenant saw {report['signals']} within "
                               f"{spec['timeout_s']} s")
        ack = "checkpointed" if role == "source" else "resumed"
        while not _acked(kube, namespace, pod, ack):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {role}'s tenant's {ack} ack never reached its pod")
            time.sleep(0.01)
    finally:
        stop.set()
        watcher.join(timeout=5.0)
    if role == "destination":
        report.update(_forward(state["params"], cfg, spec, device))
    return report


def main(argv: list[str] | None = None) -> None:
    """One end as a process on the card: prints {"ready": ...} once it
    watches, then {"report": ...}; a failure raises (exit code 1)."""
    from gpumounter_tpu_torch.k8s.client import RestKubeClient
    spec = json.loads((sys.argv[1:] if argv is None else argv)[0])
    api = spec["api"]
    kube = RestKubeClient("127.0.0.1", api["port"], api["token"], ca_file=api["ca"])
    torch.backends.cuda.matmul.allow_tf32 = False
    spec["on_ready"] = lambda r: print(json.dumps({"ready": r["ready_at"]}), flush=True)
    print(json.dumps({"report": run(kube, spec, "cuda")}), flush=True)


if __name__ == "__main__":
    main()
