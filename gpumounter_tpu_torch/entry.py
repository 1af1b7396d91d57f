"""Entry points: the probe's forward, as ``__graft_entry__.entry()`` gives
it, and the training checks of the reference's dryrun, dense
(``train_check``) and MoE (``moe_check``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.models.probe import (TransformerConfig, _attend, _block, _embed,
                                               _finish_block, _rmsnorm, forward, init_params,
                                               next_token_nll)
from gpumounter_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from gpumounter_tpu_torch.parallel.moe import _route, init_moe_params, make_moe_step
from gpumounter_tpu_torch.parallel.train_step import (loss_and_grads,
                                                      make_train_step,
                                                      tree_leaves)

TRAIN_GRAD_ATOL = 5e-3  # the reference's kernel-vs-xla grad limit
# Top-1 routing is discontinuous: a token whose two best router logits are
# closer than the two runs' logits differ may go to another expert in each,
# which changes its output wholly. The kernel and the plain attention
# differ by about a bf16 ulp, which moved router logits by at most 0.019
# at the full-width MoE config on an H100 (0.1-0.3% of tokens flipped, all
# with gaps below 0.005); a token whose top-1/top-2 gap exceeds this δ must
# route the same in both runs.
MOE_ROUTE_GAP = 0.05


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


def route_flips(xa: torch.Tensor, xa_ref: torch.Tensor, p: dict) -> dict:
    """Routing of an MoE block's FFN input in two runs: xa and xa_ref (b, t,
    d_model) are the residual streams after attention. Returns the mask of
    tokens (b, t) routed to another expert than in the ref run, the largest
    ref-run top-1/top-2 router-logit gap among them (0.0 without one), and
    the max |difference| of the router logits. Raises when a token whose
    gap exceeds MOE_ROUTE_GAP flipped."""
    h, h_ref = (_rmsnorm(a, p["ln2"]).flatten(0, 1) for a in (xa, xa_ref))
    flipped = _route(p, h)[0] != _route(p, h_ref)[0]
    logits, logits_ref = (a.float() @ p["router"] for a in (h, h_ref))
    top2 = logits_ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    worst = gap[flipped].max().item() if flipped.any() else 0.0
    logit_err = (logits - logits_ref).abs().max().item()
    if worst > MOE_ROUTE_GAP:
        raise RuntimeError(f"a token whose top-1/top-2 router-logit gap is {worst} > "
                           f"{MOE_ROUTE_GAP} went to another expert")
    return {"flipped": flipped.view(xa.shape[:2]), "worst_gap": worst, "logit_err": logit_err}


def _masked_err(got, want, keep):
    """max |got − want| over the tokens kept (keep: (b, t) bool)."""
    return ((got.float() - want.float()).abs() * keep[..., None]).max().item()


def moe_blocks_vs_plain(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                        grads: bool = False) -> list[dict]:
    """An MoE model's blocks with flash_attention against the same blocks
    with attention_plain, layer by layer: each layer's input comes from the
    kernel run, and both blocks run on it, so a routing flip changes only
    its own token. Per layer: the flipped tokens (``route_flips``, which
    raises on a flip beyond MOE_ROUTE_GAP), the block output's max abs err
    over the unflipped tokens and the plain output's max |value|.

    grads=True also gives, per layer, the grads of every block leaf and of
    the block's input ("x"): both blocks are differentiated against the
    kernel model's own cotangent of loss_fn at that block's output, with
    the flipped tokens' rows zeroed, plus the block's share of the aux
    term, so the kernel side's leaf grads are loss_fn's grads less the
    flipped tokens'. Each entry is (max abs err, plain grad's max |value|).
    """
    if cfg.n_experts is None:
        raise ValueError("moe_blocks_vs_plain needs an MoE config")
    cotangents = []
    if grads:  # loss_fn through the kernels, keeping each block's output
        x, outs, aux_total = _embed(params, tokens, cfg).detach().requires_grad_(), [], 0.0
        for blk in params["blocks"]:
            x, aux = _block(x, blk, cfg, flash_attention)
            outs.append(x)
            aux_total = aux_total + aux
        loss = (next_token_nll((x @ params["embed"].T).float(), tokens)
                + cfg.moe_aux_weight * aux_total / cfg.n_layers)
        cotangents = torch.autograd.grad(loss, outs)
    records = []
    x = _embed(params, tokens, cfg).detach()
    with torch.set_grad_enabled(grads):
        for i, blk in enumerate(params["blocks"]):
            runs = []  # (block leaves, block input, x after attention, output, aux)
            for attention in (flash_attention, attention_plain):
                leaves = {key: value.detach().requires_grad_(grads) for key, value in blk.items()}
                x_in = x.detach().requires_grad_(grads)
                xa = _attend(x_in, leaves, cfg, attention)[0]
                runs.append((leaves, x_in, xa, *_finish_block(xa, leaves)))
            (_, _, xa_k, out_k, _), (_, _, xa_p, out_p, _) = runs
            record = route_flips(xa_k, xa_p, blk)
            keep = ~record["flipped"]
            record.update(out_err=_masked_err(out_k, out_p, keep),
                          out_max=out_p.float().abs().max().item())
            if grads:
                cot = cotangents[i] * keep[..., None]
                got, want = (torch.autograd.grad(
                    (out.float() * cot.float()).sum() + cfg.moe_aux_weight * aux / cfg.n_layers,
                    [leaves[key] for key in sorted(blk)] + [x_in])
                    for leaves, x_in, _, out, aux in runs)
                record["grads"] = {name: ((g.float() - w.float()).abs().max().item(),
                                          w.float().abs().max().item())
                                   for name, g, w in zip(sorted(blk) + ["x"], got, want)}
            records.append(record)
            x = out_k.detach()
    return records


def moe_check(device="cuda") -> dict:
    """The single-GPU form of the dryrun's two MoE parts
    (``__graft_entry__.py:195-201, 268-284``). Runs on the card unless the
    caller passes device="cpu".

    1. One SGD step of the MoE flagship: train_check's config (the
       reference's flagship at d_head 32) with n_experts 8 and d_ff 64, as
       the dryrun replaces them, on tokens (8, 16) from numpy seed 0. Its
       grads through the kernels are held against those through the plain
       attention within the reference's 5e-3, block by block
       (``moe_blocks_vs_plain``): a routing flip is a discontinuity, not a
       fault, and the block check leaves the flipped tokens out.
    2. Three steps of the standalone MoE layer, ``make_moe_step`` with 2
       experts, d_model 32, d_ff 64, on bf16 ones (8, 32) as input and
       target.

    Returns {"loss", "max_grad_err", "flipped" (per layer),
    "moe_step_losses"}; raises RuntimeError when a loss is not finite or a
    grad is off.
    """
    device = resolve_device(device)
    cfg = TransformerConfig(n_layers=2, d_model=512, n_heads=16, d_ff=64, max_len=32,
                            n_kv_heads=8, window=8, rope=True, n_experts=8)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (8, 16))).to(device)
    new, loss = make_train_step(cfg)(params, tokens)
    if not (torch.isfinite(loss) and all(torch.isfinite(t).all() for t in tree_leaves(new))):
        raise RuntimeError(f"MoE train step: loss {loss.item()}, or params not finite")
    records = moe_blocks_vs_plain(params, tokens, cfg, grads=True)
    err = max(e for record in records for e, _ in record["grads"].values())
    if not err < TRAIN_GRAD_ATOL:
        raise RuntimeError(f"MoE grads through the kernels vs the plain attention: max "
                           f"abs err {err} >= {TRAIN_GRAD_ATOL}")

    step = make_moe_step(2, 32, 64)
    moe_params = init_moe_params(torch.Generator().manual_seed(1), 2, 32, 64,
                                 torch.bfloat16, device)
    xs = torch.ones((8, 32), dtype=torch.bfloat16, device=device)
    moe_losses = []
    for _ in range(3):
        moe_params, moe_loss = step(moe_params, xs, xs)
        moe_losses.append(moe_loss.item())
    if not all(map(math.isfinite, moe_losses)):
        raise RuntimeError(f"MoE layer step losses not finite: {moe_losses}")
    return {"loss": loss.item(), "max_grad_err": err,
            "flipped": [int(r["flipped"].sum()) for r in records],
            "moe_step_losses": moe_losses}
