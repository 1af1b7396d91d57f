"""The probe's training step on one device.

Counterpart of ``gpumounter_tpu/parallel/train_step.py`` without the mesh:
``sgd_update``, ``make_train_step`` and ``make_train_step_optim`` (the shape
of ``make_train_step_optax``, over ``torch.optim``). Params are the probe's
plain dict (``models.probe.init_params``); gradients come from
``torch.autograd`` through ``models.probe.loss_fn``, so on the card every
block's attention runs the forward kernel with lse and the two backward
kernels.

Not ported here: the mesh, ``param_specs``, ``shard_params`` and the optax
step's refusal of optimizer state that does not mirror the params. They are
about sharding and belong to the multi-GPU slice.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.models.probe import TransformerConfig, loss_fn
from gpumounter_tpu_torch.ops.flash_attention import flash_attention


def tree_leaves(params: dict) -> list[torch.Tensor]:
    """The params' tensors in a fixed order: the top-level keys sorted,
    then each block's keys sorted (the order of ``jax.tree.leaves`` within
    each level)."""
    top = [params[key] for key in sorted(params) if key != "blocks"]
    return top + [blk[key] for blk in params["blocks"] for key in sorted(blk)]


def tree_map(fn, params: dict, *rest: dict) -> dict:
    """A params dict of fn(leaf, *matching leaves of rest)."""
    out = {key: fn(params[key], *(r[key] for r in rest))
           for key in sorted(params) if key != "blocks"}
    out["blocks"] = [{key: fn(blk[key], *(r["blocks"][i][key] for r in rest))
                      for key in sorted(blk)}
                     for i, blk in enumerate(params["blocks"])]
    return out


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   attention=flash_attention) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_fn``: the counterpart of
    ``jax.value_and_grad(loss_fn)``. grads has the params' layout and
    dtypes; params are left as they are."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(leaves, tokens, cfg, attention)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


@torch.no_grad()
def sgd_update(params: dict, grads: dict, lr: float) -> dict:
    """float32 SGD update cast back to each param's dtype, as new tensors."""
    return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                    params, grads)


def make_train_step(cfg: TransformerConfig, lr: float = 1e-3):
    """Returns step(params, tokens) -> (new params, loss)."""

    def step(params, tokens):
        loss, grads = loss_and_grads(params, tokens, cfg)
        return sgd_update(params, grads, lr), loss

    return step


def make_train_step_optim(cfg: TransformerConfig, make_optimizer):
    """A train step driven by a ``torch.optim`` optimizer, in the shape of
    the reference's ``make_train_step_optax``. Returns (init_fn, step_fn):

        opt_state = init_fn(params)       # make_optimizer(tree_leaves(params))
        params, opt_state, loss = step_fn(params, opt_state, tokens)

    e.g. ``make_optimizer=lambda ps: torch.optim.AdamW(ps, lr=1e-3,
    weight_decay=1e-4)``, the counterpart of ``optax.adamw(1e-3,
    weight_decay=1e-4)``. torch.optim updates in place where optax returns
    new arrays: init_fn marks the params' tensors as requiring grad, and
    step_fn returns the same dict with its tensors updated.
    """

    def init_fn(params):
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        return make_optimizer(leaves)

    def step_fn(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn
