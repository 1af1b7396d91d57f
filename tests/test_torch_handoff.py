"""The hot-add handoff as a whole, on the CPU, against the JAX reference.

The reference takes 2 optax AdamW steps, packs, saves, loads and restores
onto a one-device CPU mesh, and takes a third. The port takes 2 steps in a
child process (``tests/torch_handoff_child.py``), which hands over to a new
image of itself (``handoff``: save, flush, exec; same PID); the new image
loads, restores and takes the third. Its params must match the reference's
within the AdamW tolerance of ``test_torch_train_step`` and the port's own
uninterrupted 3 steps to the bit.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from gpumounter_tpu.jaxside.resume import HotResumable as JaxResumable
from gpumounter_tpu_torch.models import probe as tprobe

from test_torch_probe import SMALL, _both, _jax_cfg
from test_torch_train_step import _assert_tree_close, _jax_value_and_grad, _tokens
from torch_handoff_child import (ADAMW, SEED, STEPS_AFTER, STEPS_BEFORE,
                                 assert_handoff_results, run_handoff_child,
                                 uninterrupted)


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def test_handoff_matches_reference_and_the_uninterrupted_run(tmp_path):
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **SMALL)
    jparams, params = _both(cfg, seed=3)
    shape = (2, 16)
    results, pid, out = run_handoff_child(tmp_path, cfg, params, "cpu", shape)

    # The reference: 2 steps, the durable round trip onto a 1-device mesh, 1 step.
    tx = optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0], b2=ADAMW["betas"][1],
                     eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])
    jcfg, jstate, want_losses = _jax_cfg(cfg), tx.init(jparams), []
    for i in range(STEPS_BEFORE + STEPS_AFTER):
        if i == STEPS_BEFORE:
            JaxResumable.pack(jparams, jstate).save(str(tmp_path / "jax"))
            mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
            jparams, jstate = JaxResumable.load(str(tmp_path / "jax")).restore(mesh)
        loss, grads = _jax_value_and_grad(jparams, _tokens(cfg, shape, seed=SEED + i), jcfg)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_losses.append(loss)

    params, losses = uninterrupted(cfg, params, "cpu", shape)
    assert_handoff_results(results, pid, out, params, losses)
    np.testing.assert_allclose(results["losses"].numpy(), want_losses, atol=2e-6, rtol=0)
    _assert_tree_close(results["params"], jax.tree.map(np.asarray, jparams), 1e-4)
