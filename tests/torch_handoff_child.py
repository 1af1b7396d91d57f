"""A tenant program for the handoff tests: it trains the probe, hands over
to a new process image of itself, and trains on there.

    python tests/torch_handoff_child.py SPEC

SPEC is a JSON object: ``device``; ``cfg`` (``TransformerConfig`` fields,
``dtype`` by name); ``init`` (a checkpoint of the initial params);
``ckpt`` (the handoff's checkpoint); ``out`` (where the new image saves
its results); ``shape`` (B, L) of the token batches, drawn by numpy from
seed SEED + step.

The first image loads the initial params, takes STEPS_BEFORE AdamW steps,
prints their losses without flushing (``handoff`` flushes) and calls
``handoff`` with its defaults: the same arguments and environment. The
new image finds the checkpoint, restores it onto the device, takes
STEPS_AFTER steps and saves ``{"params", "losses", "pids", "launches"}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpumounter_tpu_torch.models.probe import TransformerConfig  # noqa: E402
from gpumounter_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd_kernel, flash_attention_kernel)
from gpumounter_tpu_torch.parallel.train_step import (make_train_step_optim,  # noqa: E402
                                                      tree_leaves)
from gpumounter_tpu_torch.torchside import (HotResumable, handoff,  # noqa: E402
                                            load_optimizer_state,
                                            optimizer_state_tree)

ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
SEED, STEPS_BEFORE, STEPS_AFTER = 20, 2, 1
# CPU threads of both runs, so that they sum in the same order; one keeps
# the child light beside the other test workers.
THREADS = 1


def _launches() -> dict:
    return {"flash_fwd": flash_attention_kernel.launches,
            "dq": flash_attention_bwd_kernel.dq_launches,
            "dkv": flash_attention_bwd_kernel.dkv_launches}


def main(spec: dict) -> None:
    torch.set_num_threads(THREADS)
    cfg = TransformerConfig(**{**spec["cfg"], "dtype": getattr(torch, spec["cfg"]["dtype"])})
    init_fn, step_fn = make_train_step_optim(
        cfg, lambda ps: torch.optim.AdamW(ps, **ADAMW))

    def batch(step):
        rng = np.random.default_rng(SEED + step)
        return torch.from_numpy(rng.integers(0, cfg.vocab, spec["shape"])).to(spec["device"])

    def steps(params, opt, first, n):
        losses = []
        for i in range(first, first + n):
            params, opt, loss = step_fn(params, opt, batch(i))
            losses.append(loss)
        return params, opt, torch.stack(losses)

    if not os.path.exists(os.path.join(spec["ckpt"], "LATEST")):
        (params,) = HotResumable.load(spec["init"]).restore(spec["device"])
        params, opt, losses = steps(params, init_fn(params), 0, STEPS_BEFORE)
        print(f"first image, pid {os.getpid()}: losses {losses.tolist()}")
        handoff(HotResumable.pack(params, optimizer_state_tree(opt), losses,
                                  os.getpid(), _launches()), spec["ckpt"])
    params, tree, losses, pid, launches = HotResumable.load(spec["ckpt"]).restore(spec["device"])
    opt = init_fn(params)
    load_optimizer_state(opt, tree)
    params, opt, more = steps(params, opt, STEPS_BEFORE, STEPS_AFTER)
    HotResumable.pack({"params": params, "losses": torch.cat([losses, more]),
                       "pids": [pid, os.getpid()],
                       "launches": [launches, _launches()]}).save(spec["out"])
    print(f"new image, pid {os.getpid()}: losses {more.tolist()}")


# --- for the tests that run this program ---

def run_handoff_child(tmp_path, cfg, params, device, shape, timeout=300):
    """Run the child program on `params`; returns (its results tree, its
    pid, its stdout)."""
    HotResumable.pack(params).save(str(tmp_path / "init"))
    spec = {"device": device,
            "cfg": {**dataclasses.asdict(cfg), "dtype": str(cfg.dtype).removeprefix("torch.")},
            "init": str(tmp_path / "init"), "ckpt": str(tmp_path / "ckpt"),
            "out": str(tmp_path / "out"), "shape": list(shape)}
    proc = subprocess.Popen([sys.executable, __file__, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    (results,) = HotResumable.load(str(tmp_path / "out")).restore("cpu")
    return results, proc.pid, out


def uninterrupted(cfg, params, device, shape):
    """The same steps in this process, without a handoff, on THREADS CPU
    threads as the child: (params, losses)."""
    init_fn, step_fn = make_train_step_optim(
        cfg, lambda ps: torch.optim.AdamW(ps, **ADAMW))
    opt, losses = init_fn(params), []
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for i in range(STEPS_BEFORE + STEPS_AFTER):
            tokens = np.random.default_rng(SEED + i).integers(0, cfg.vocab, shape)
            params, opt, loss = step_fn(params, opt, torch.from_numpy(tokens).to(device))
            losses.append(loss)
    finally:
        torch.set_num_threads(threads)
    return params, torch.stack(losses)


def assert_handoff_results(results, pid, out, params, losses):
    """One PID across the exec, the first image's unflushed output kept,
    losses and params equal to the uninterrupted run's to the bit."""
    assert [int(p) for p in results["pids"]] == [pid, pid]
    assert f"first image, pid {pid}: losses" in out and "new image" in out
    assert torch.equal(results["losses"], losses.cpu())
    for got, want in zip(tree_leaves(results["params"]), tree_leaves(params), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want.detach().cpu())


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
