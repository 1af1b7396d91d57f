"""Entry points: the probe's forward, as ``__graft_entry__.entry()`` gives
it, and the training check of the reference's dryrun."""

from __future__ import annotations

import numpy as np
import torch

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.models.probe import (TransformerConfig, forward,
                                               init_params)
from gpumounter_tpu_torch.ops.flash_attention import attention_plain
from gpumounter_tpu_torch.parallel.train_step import (loss_and_grads,
                                                      make_train_step,
                                                      tree_leaves)

TRAIN_GRAD_ATOL = 5e-3  # the reference's kernel-vs-xla grad limit


def entry(device="cuda"):
    """(fn, example_args): the forward step of the default probe config,
    seeded weights, zero tokens (4, 32). Runs on the card unless the caller
    passes device="cpu"."""
    device = resolve_device(device)
    cfg = TransformerConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.zeros((4, 32), dtype=torch.long, device=device)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def train_check(device="cuda") -> dict:
    """One SGD step of the reference's flagship dialect on tokens (8, 16)
    from numpy seed 0, then its grads through the kernels held leaf by leaf
    against the grads with ``attention=attention_plain`` (autograd through
    the plain forward), within the reference's 5e-3: the single-GPU form of
    ``__graft_entry__.py:150-167``. Runs on the card unless the caller
    passes device="cpu".

    The config is ``__graft_entry__._flagship_cfg`` (16 q heads, 8 kv
    heads, window 8, RoPE, 2 layers, d_ff 128, max_len 32, bf16) at
    d_model 512 in place of 64. The flagship's d_head is 64 / 16 = 4, and
    no kernel of the port takes it: flash_fwd.cu and flash_bwd.cu take
    head dims 32, 64 and 128, and a CUDA tensor with another head dim
    raises ValueError. The kernels do not pad small head dims; this check
    uses d_head 32 and keeps every other field.

    Returns {"loss": ..., "max_grad_err": ...}; raises RuntimeError when
    the loss is not finite or a grad is off.
    """
    device = resolve_device(device)
    cfg = TransformerConfig(n_layers=2, d_model=512, n_heads=16, d_ff=128,
                            max_len=32, n_kv_heads=8, window=8, rope=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (8, 16))).to(device)
    _, loss = make_train_step(cfg)(params, tokens)
    if not torch.isfinite(loss):
        raise RuntimeError(f"train step loss is not finite: {loss.item()}")
    _, grads = loss_and_grads(params, tokens, cfg)
    _, plain = loss_and_grads(params, tokens, cfg, attention=attention_plain)
    err = max((g.float() - p.float()).abs().max().item()
              for g, p in zip(tree_leaves(grads), tree_leaves(plain)))
    if not err < TRAIN_GRAD_ATOL:
        raise RuntimeError(f"grads through the kernels vs the plain "
                           f"attention: max abs err {err} >= "
                           f"{TRAIN_GRAD_ATOL}")
    return {"loss": loss.item(), "max_grad_err": err}
