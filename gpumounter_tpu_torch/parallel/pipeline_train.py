"""Pipeline-parallel (pp) training of the probe.

Counterpart of ``gpumounter_tpu/parallel/pipeline_train.py``: microbatch-
pipelined training over the probe's blocks on a one-axis ("pipe",) mesh of
P ranks, each holding its share of the block stack (stage-stacked params,
``to_pipeline_params`` then ``shard_pipeline_params``). Activations move
stage to stage inside ``parallel.pipeline``'s schedule, and autograd
differentiates through it, so one step runs the forward, the backward and
the SGD update.

Two schedules: GPipe (``n_virtual=1``, each rank one contiguous chunk of
blocks) and interleaved (``n_virtual=v``, each rank v non-contiguous chunks,
logical stage k·P + d on rank d). Inside a stage the blocks run
``models.probe._block`` without a mesh, so on a CUDA rank every block's
attention runs the forward kernel with lse and both backward kernels, once
a (microbatch, chunk) of the schedule.

The embedding and the logits live outside the pipeline, on every rank:
each rank computes the whole loss from the pipeline's output (which every
rank receives), the embedding's gradient comes out whole and equal on
every rank (its input side through the pipeline's f), and each rank's
stage gradients are its own. No gradient is summed across ranks.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.models.probe import TransformerConfig, _block, _embed, next_token_nll
from gpumounter_tpu_torch.ops.flash_attention import flash_attention
from gpumounter_tpu_torch.parallel.pipeline import (pipeline_apply, schedule_info,
                                                    shard_stage_params)
from gpumounter_tpu_torch.parallel.train_step import sgd_update, tree_leaves, tree_map


def _stack(trees: list) -> dict:
    """One dict of the trees' leaves stacked along a new leading axis."""
    return {key: torch.stack([t[key] for t in trees]) for key in trees[0]}


def to_pipeline_params(params: dict, n_stages: int, n_virtual: int = 1) -> dict:
    """Regroup ``init_params`` output for a pipeline of P = n_stages ranks
    and v = n_virtual chunks a rank.

    The block list becomes stage-stacked leaves: (P, L/P, ...) for GPipe,
    (P, v, L/(P·v), ...) interleaved — logical stage s = k·P + d (rank d,
    chunk k) owns blocks [s·per, (s+1)·per). embed (and pos) stay as they
    are.
    """
    blocks = params["blocks"]
    total = n_stages * n_virtual
    if len(blocks) % total:
        raise ValueError(f"n_layers ({len(blocks)}) must divide by "
                         f"n_stages*n_virtual ({n_stages}*{n_virtual})")
    per = len(blocks) // total

    def logical_stage(s: int) -> dict:
        return _stack(blocks[s * per:(s + 1) * per])

    if n_virtual == 1:
        stages = [logical_stage(d) for d in range(n_stages)]
    else:  # device-major, chunk-minor: leaf axes (P, v, per, ...)
        stages = [_stack([logical_stage(k * n_stages + d) for k in range(n_virtual)])
                  for d in range(n_stages)]
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["stages"] = _stack(stages)
    return out


def shard_pipeline_params(params: dict, mesh, pipe_axis: str = "pipe") -> dict:
    """This rank's pipeline params on the mesh's device: its block of the
    stages (leading pipe axis kept, of size 1), embed and pos whole."""
    placed = {k: v.to(mesh.device, copy=True) for k, v in params.items() if k != "stages"}
    placed["stages"] = shard_stage_params(params["stages"], mesh, pipe_axis)
    return placed


def make_pipeline_train_step(mesh, cfg: TransformerConfig, n_micro: int, lr: float = 1e-3,
                             pipe_axis: str = "pipe", n_virtual: int = 1):
    """step(params, tokens) -> (params, loss) over a ("pipe",) mesh.

    params: this rank's ``shard_pipeline_params(to_pipeline_params(
    init_params(cfg, ...), P, v), mesh)``; tokens: the whole batch (B, L)
    on every rank. Returns this rank's new params and the whole batch's
    loss (the same on every rank). n_virtual=v > 1 selects the interleaved
    schedule (bubble fraction ~ (P-1)/(M·v+P-1) instead of GPipe's
    (P-1)/(M+P-1)). Restrictions, as the reference's: n_layers divisible by
    P·v, n_micro >= P, dense FFN only (the MoE aux loss would need
    cross-stage accumulation the schedule does not carry), and
    attn_parallel "heads" (each stage attends its full sequence locally).
    Every rank of the axis must call the step together.
    """
    n_stages = mesh.size(pipe_axis)
    total = n_stages * n_virtual
    if cfg.n_layers % total:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide by "
                         f"pipeline stages*chunks ({n_stages}*{n_virtual})")
    if n_micro < n_stages:
        # With M < P the ramp never fills: at least one rank idles more
        # than half the schedule. Refuse rather than train at a fraction of
        # the hardware.
        info = schedule_info(n_micro, n_stages, n_virtual)
        raise ValueError(
            f"n_micro ({n_micro}) must be >= pipeline stages "
            f"({n_stages}): bubble fraction would be "
            f"{info['bubble_fraction']:.2f} "
            f"({info['bubble_ticks']}/{info['ticks']} ticks)")
    if cfg.n_experts is not None:
        raise ValueError("pipeline training supports dense FFN only "
                         "(MoE aux loss is not carried across stages)")
    if cfg.attn_parallel != "heads":
        raise ValueError("pipeline training requires "
                         "attn_parallel='heads'")
    per = cfg.n_layers // total

    def stage_fn(chunk_params, x):
        for i in range(per):
            x, _aux = _block(x, {k: a[i] for k, a in chunk_params.items()}, cfg,
                             flash_attention)
        return x

    def loss_fn(params, tokens):
        x = _embed(params, tokens, cfg)
        x = pipeline_apply(params["stages"], x, mesh, stage_fn, n_micro=n_micro,
                           pipe_axis=pipe_axis, n_virtual=n_virtual)
        return next_token_nll((x @ params["embed"].T).float(), tokens)

    def step(params, tokens):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(leaves, tokens.to(mesh.device))
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        return sgd_update(params, tree_map(lambda _: next(grads), params), lr), loss.detach()

    return step
