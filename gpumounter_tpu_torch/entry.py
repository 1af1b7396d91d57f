"""Entry points: the probe's forward, as ``__graft_entry__.entry()`` gives
it, and the training checks of the reference's dryrun, dense
(``train_check``), MoE (``moe_check``) and sharded over a mesh of ranks:
dp x tp and expert parallelism (``tp_train_check``), dp x sp with ring
attention and the pipelines (``seq_pipeline_check``), all of them with the
stretch over an H100 topology plan (``dryrun_multichip``); and the
hot-add that grows a job's mesh (``grow_check``)."""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.models.probe import (TransformerConfig, _attend, _block, _embed,
                                               _finish_block, _rmsnorm, forward, init_params,
                                               local_heads, loss_fn, next_token_nll)
from gpumounter_tpu_torch.ops.flash_attention import (attention_plain, flash_attention,
                                                      flash_attention_bwd_kernel,
                                                      flash_attention_kernel)
from gpumounter_tpu_torch.parallel.collectives import all_gather
from gpumounter_tpu_torch.parallel.launch import run_ranks
from gpumounter_tpu_torch.parallel.mesh import build_mesh, shard_qkv
from gpumounter_tpu_torch.parallel.moe import (_route, init_moe_params, make_moe_step,
                                               shard_moe_params)
from gpumounter_tpu_torch.parallel.pipeline import (pipeline_apply, schedule_info,
                                                    shard_stage_params)
from gpumounter_tpu_torch.parallel.pipeline_train import (make_pipeline_train_step,
                                                          shard_pipeline_params,
                                                          to_pipeline_params)
from gpumounter_tpu_torch.parallel.ring_attention import reference_attention, ring_attention
from gpumounter_tpu_torch.parallel.train_step import (gather_params, loss_and_grads,
                                                      make_train_step, make_train_step_optim,
                                                      param_specs, shard_params,
                                                      step_collectives, tree_leaves, tree_map,
                                                      tree_names)
from gpumounter_tpu_torch.topology import lookup
from gpumounter_tpu_torch.torchside.resume import (HotResumable, load_optimizer_state,
                                                   optimizer_state_specs, optimizer_state_tree)

TRAIN_GRAD_ATOL = 5e-3  # the reference's kernel-vs-xla grad limit
# The dryrun's limits: a sharded first-step loss against the unsharded loss
# (__graft_entry__.py:221-224, 333-336), ring attention against the
# one-process oracle (:241-243, :253-255).
SHARDED_LOSS_ATOL = 1e-2
RING_TOL = dict(rtol=5e-2, atol=5e-2)
# Top-1 routing is discontinuous: a token whose two best router logits are
# closer than the two runs' logits differ may go to another expert in each,
# which changes its output wholly. The kernel and the plain attention
# differ by about a bf16 ulp, which moved router logits by at most 0.019
# at the full-width MoE config on an H100 (0.1-0.3% of tokens flipped, all
# with gaps below 0.005); a token whose top-1/top-2 gap exceeds this δ must
# route the same in both runs.
MOE_ROUTE_GAP = 0.05
# A sharded SGD step against the one-process step on the same card, weights
# and tokens. Each new weight is p − lr·g rounded to bf16. g differs by a
# few bf16 ulps (g sums wo's and w2's bf16 partial products where one
# matmul rounds once, and the data shards' bf16 grads are summed in bf16),
# lr·g is far below an ulp of p, but the rounding can land on p's
# neighbour: each leaf within 1 bf16 ulp of its max |value| (2^-7 of it).
# An AdamW update is about lr whatever g, so ``grow_restore`` holds one to
# this limit only with the same gradients on both sides.
SHARDED_PARAM_OF_MAX = 2**-7
# The loss, dense: the mean of 4 x 2047 NLLs of logits about an ulp apart
# (the forward's limit, 1e-3). MoE: a routing flip between the two runs
# moves its position's NLL by about a nat, the mean over 8188 positions by
# about 1.2e-4; 0.01 allows 80 flips, 1% of a layer's tokens (0.1-0.3%
# flipped between two attentions an ulp apart on an H100; MOE_ROUTE_GAP).
ONE_PROCESS_LOSS_ATOL = {"dense": 1e-3, "MoE": 0.01}
# The grow check's optimizer: the reference's optax.adamw(1e-3,
# weight_decay=1e-4); and the seed of its weights and token batches.
GROW_ADAMW = dict(lr=1e-3, weight_decay=1e-4)
GROW_SEED = 400
# Host-clock parts of a hot-add that are cheap to repeat, each timed so
# often (the median is reported).
GROW_REPEATS = 3
# The dryrun's token batch: (8, 16), as the reference's.
DRYRUN_TOKENS = (8, 16)
# The dryrun's stretch: the reference's v5litepod-16 run over 16 devices,
# laid out by the H100 plan (2 hosts of 8).
STRETCH = dict(ACCEL="nvidia-h100-80gb", GPUS=16, SEED=2)


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


def check_config(**changes) -> TransformerConfig:
    """The checks' dialect: the reference's dryrun flagship
    (``__graft_entry__._flagship_cfg``: 16 q heads, 8 kv heads, window 8,
    RoPE, 2 layers, d_ff 128, max_len 32, bf16) at d_model 512, so d_head
    32 (``train_check`` says why), with `changes`."""
    cfg = TransformerConfig(n_layers=2, d_model=512, n_heads=16, d_ff=128,
                            max_len=32, n_kv_heads=8, window=8, rope=True)
    return dataclasses.replace(cfg, **changes)


def check_tokens(cfg, split: int = 1) -> torch.Tensor:
    """The checks' batch: tokens (8, 16) from numpy seed 0, on the CPU; its
    first split·⌊8/split⌋ rows, so that they split `split` ways (all of
    them where split divides 8)."""
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, DRYRUN_TOKENS)
    return torch.from_numpy(tokens[:split * (DRYRUN_TOKENS[0] // split)])


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
    cfg = check_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = check_tokens(cfg).to(device)
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
    cfg = check_config(n_experts=8, d_ff=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = check_tokens(cfg).to(device)
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


# --- sharded: the dryrun's dp x tp and expert-parallel sections ---


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_launches() -> dict:
    """The training kernels' launch counts in this process."""
    bwd = flash_attention_bwd_kernel
    return {"flash_fwd": flash_attention_kernel.launches, "dq": bwd.dq_launches,
            "dkv": bwd.dkv_launches}


def reset_kernel_launches() -> None:
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.dq_launches = flash_attention_bwd_kernel.dkv_launches = 0


def local_shapes(cfg: TransformerConfig, mesh) -> list[tuple]:
    """The shapes of one rank's shards, in ``tree_leaves`` order: each
    leaf's whole shape with the dim that ``param_specs`` splits over
    "model" divided by its size, and wqkv's columns those of the rank's
    q, k and v heads."""
    tp = mesh.size("model")
    n_q, n_kv = local_heads(cfg, mesh)
    full = {"embed": (cfg.vocab, cfg.d_model), "pos": (cfg.max_len, cfg.d_model),
            "wqkv": (cfg.d_model, (n_q + 2 * n_kv) * cfg.d_head * tp),
            "wo": (cfg.d_model, cfg.d_model), "ln1": (cfg.d_model,), "ln2": (cfg.d_model,),
            "w1": (cfg.d_model, cfg.d_ff), "w2": (cfg.d_ff, cfg.d_model)}
    if cfg.n_experts is not None:
        e = cfg.n_experts
        full.update(router=(cfg.d_model, e), w1=(e, cfg.d_model, cfg.d_ff),
                    w2=(e, cfg.d_ff, cfg.d_model))

    def local(key, spec):
        return tuple(n // tp if axis == "model" else n for n, axis in zip(full[key], spec))

    specs = param_specs(cfg)
    return ([local(k, specs[k]) for k in sorted(specs) if k != "blocks"]
            + [local(k, blk[k]) for blk in specs["blocks"] for k in sorted(blk)])


def _check_equal_over(local: dict, mesh, axis: str, keys=None) -> None:
    """Raises unless each leaf named in `keys` (every leaf by default) is
    bit-equal on every rank along `axis`."""
    for name, leaf in zip(tree_names(local), tree_leaves(local), strict=True):
        if keys is None or name.rsplit(".", 1)[-1] in keys:
            for r, other in enumerate(all_gather(leaf, mesh, axis)):
                if not torch.equal(other, leaf):
                    raise RuntimeError(f"{name} differs between rank {mesh.rank} and its "
                                       f"{axis!r} neighbour {r} after the step")


def sharded_step_check(cfg: TransformerConfig, mesh, params: dict, tokens: torch.Tensor,
                       lr: float = 1e-3) -> dict:
    """One ``make_train_step`` step of full params (on the CPU: only the
    shards reach the device) sharded over `mesh`, with the checks that
    stand in for the dryrun's "no involuntary rematerialization": this
    rank's leaves, before and after, have their local shapes; the step's
    collectives are ``step_collectives``' all-reduces, of its own shards
    and activations, and nothing gathers a weight; and after the step every
    leaf is bit-equal along "data", and every replicated one along
    "model". On a CUDA mesh each training kernel launches n_layers times,
    on this rank's heads. Returns {"local": new shards, "loss", "launches",
    "collectives"}; raises RuntimeError when a check fails."""
    local = shard_params(params, mesh, cfg)
    want = local_shapes(cfg, mesh)
    got = [tuple(t.shape) for t in tree_leaves(local)]
    if got != want:
        raise RuntimeError(f"rank {mesh.rank}: shards of shapes {got}, expected {want}")
    step = make_train_step(cfg, lr=lr, mesh=mesh)
    mesh.reset_counts()
    reset_kernel_launches()
    new, loss = step(local, tokens)
    _sync(mesh.device)
    counts = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
    launches = kernel_launches()
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"rank {mesh.rank}: sharded step loss {loss.item()}")
    expected = step_collectives(cfg, mesh, local, tuple(tokens.shape))
    if counts != expected:
        raise RuntimeError(f"rank {mesh.rank}: collectives of a step {counts}, "
                           f"expected {expected}")
    n = cfg.n_layers if mesh.device.type == "cuda" else 0
    if launches != dict.fromkeys(("flash_fwd", "dq", "dkv"), n):
        raise RuntimeError(f"rank {mesh.rank}: kernel launches {launches}, {n} each expected")
    if [tuple(t.shape) for t in tree_leaves(new)] != want:
        raise RuntimeError(f"rank {mesh.rank}: the new shards changed shape")
    _check_equal_over(new, mesh, "data")
    _check_equal_over(new, mesh, "model", {"embed", "pos", "ln1", "ln2", "router"})
    return {"local": new, "loss": loss.item(), "launches": launches, "collectives": counts}


def tp_checks(mesh) -> dict:
    """The dryrun's sharded sections (``__graft_entry__.py:141-167, 191-201,
    268-284``) on this rank of a ("data", "model") mesh, at ``check_config``'s
    dialect; every rank of the mesh calls it together.

    1. One dp x tp SGD step (``sharded_step_check``), finite loss.
    2. Its gradients through the kernels held against those through
       ``attention_plain`` on the same mesh, leaf by leaf on this rank's
       shards, within the reference's 5e-3; each attention call on
       H/tp q heads and H_kv/tp kv heads.
    3. The MoE flagship (8 experts, d_ff 64) over the same mesh, its
       experts split over "model": one step, the same checks.
    4. ``make_moe_step`` over a ("data", "expert") mesh of the same ranks
       (2 experts a rank of "expert", 2 ranks on it where the world is
       even), 3 steps of d_model 32, d_ff 64 on bf16 ones (8, 32).

    Each batch is its first rows that split over "data" (all 8 unless the
    data axis does not divide 8).

    Returns {"loss", "max_grad_err", "heads", "launches", "collectives",
    "moe_loss", "moe_launches", "moe_collectives", "moe_step_losses"}."""
    cfg = check_config()
    tokens = check_tokens(cfg, mesh.size("data"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dense = sharded_step_check(cfg, mesh, params, tokens)

    local = shard_params(params, mesh, cfg)
    heads = []

    def recording(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return flash_attention(q, k, v, **kw)

    _, grads = loss_and_grads(local, tokens, cfg, attention=recording, mesh=mesh)
    _, plain = loss_and_grads(local, tokens, cfg, attention=attention_plain, mesh=mesh)
    if heads != [local_heads(cfg, mesh)] * cfg.n_layers:
        raise RuntimeError(f"rank {mesh.rank}: attention ran on (q, kv) heads {heads}")
    err = max((g.float() - p.float()).abs().max().item()
              for g, p in zip(tree_leaves(grads), tree_leaves(plain)))
    if not err < TRAIN_GRAD_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: grads through the kernels vs the plain "
                           f"attention on the mesh: max abs err {err} >= {TRAIN_GRAD_ATOL}")

    moe_cfg = check_config(n_experts=8, d_ff=64)
    moe = sharded_step_check(moe_cfg, mesh, init_params(
        moe_cfg, torch.Generator().manual_seed(0), "cpu"), tokens)

    world = mesh.size("data") * mesh.size("model")
    ep = 2 if world % 2 == 0 else 1
    expert_mesh = build_mesh((world // ep, ep), ("data", "expert"), mesh.device)
    step = make_moe_step(2 * ep, 32, 64, mesh=expert_mesh)
    moe_params = shard_moe_params(init_moe_params(
        torch.Generator().manual_seed(1), 2 * ep, 32, 64, torch.bfloat16, "cpu"), expert_mesh)
    n_data = world // ep
    xs = torch.ones((n_data * (DRYRUN_TOKENS[0] // n_data), 32), dtype=torch.bfloat16)
    moe_losses = []
    for _ in range(3):
        moe_params, moe_loss = step(moe_params, xs, xs)
        moe_losses.append(moe_loss.item())
    if not all(map(math.isfinite, moe_losses)):
        raise RuntimeError(f"rank {mesh.rank}: MoE layer step losses {moe_losses}")
    return {"loss": dense["loss"], "max_grad_err": err, "heads": heads,
            "launches": dense["launches"], "collectives": dense["collectives"],
            "moe_loss": moe["loss"], "moe_launches": moe["launches"],
            "moe_collectives": moe["collectives"],
            "moe_step_losses": moe_losses}


def _tp_check_rank(shape, device) -> dict:
    result = tp_checks(build_mesh(shape, device=device))
    result["rank"] = torch.distributed.get_rank()
    return result


def tp_train_check(n_data: int, n_model: int, device="cuda", *, backend: str,
                   timeout_s: float = 600.0) -> dict:
    """``tp_checks`` on an (n_data, n_model) mesh of n_data x n_model
    ranks, started as processes (``parallel.launch.run_ranks``) that join a
    process group of `backend`: the counterpart of the dryrun's dp x tp
    and expert-parallel sections on a mesh. The caller names the backend;
    nothing here swaps one for another (NCCL refuses two ranks on one
    device, gloo takes CUDA tensors by way of the host). Runs on the card
    unless the caller passes device="cpu"; each rank's device is
    ``build_mesh``'s. Returns rank 0's results, with "max_grad_err" the
    largest over the ranks and "ranks" every rank's; raises when a rank
    fails, naming it."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    results = run_ranks(_tp_check_rank, n_data * n_model, backend=backend,
                        args=((n_data, n_model), device), timeout_s=timeout_s)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise RuntimeError(f"the ranks' losses differ: {sorted(losses)}")
    return {**results[0], "max_grad_err": max(r["max_grad_err"] for r in results),
            "ranks": results}


# --- sharded: the dryrun's dp x sp, ring and pipeline sections ---


def _dryrun_config(device: torch.device, **changes) -> TransformerConfig:
    """The dryrun's flagship (d_head 4) on the CPU; ``check_config``'s
    dialect (d_head 32) on the card, whose kernels take head dims 32, 64
    and 128."""
    if device.type == "cuda":
        return check_config(**changes)
    return check_config(d_model=64, **changes)


def _ring_case(mesh, shape: tuple, seed: int, grads: bool) -> dict:
    """ring_attention over the ("seq",) mesh on this rank's chunks of
    numpy-seeded q, k, v (normal x 0.3, f32) against reference_attention
    over the whole sequence, within RING_TOL; with grads, also the gradient
    of sum(out²) in q, which must be finite. Returns the max abs error."""
    rng = np.random.default_rng(seed)
    full = [torch.from_numpy(rng.normal(size=shape) * 0.3).float() for _ in range(3)]
    q, k, v = (shard_qkv(t, mesh).requires_grad_(grads) for t in full)
    out = ring_attention(q, k, v, mesh)
    want = shard_qkv(reference_attention(*full), mesh)
    if not torch.allclose(out.detach(), want, **RING_TOL):
        raise RuntimeError(f"rank {mesh.rank}: ring attention at {shape} differs from "
                           f"reference_attention")
    result = {"max_abs_err": (out.detach() - want).abs().max().item()}
    if grads:
        (dq,) = torch.autograd.grad(out.square().sum(), [q])
        if not torch.isfinite(dq).all():
            raise RuntimeError(f"rank {mesh.rank}: ring attention's grad is not finite")
    return result


def seq_checks(mesh) -> dict:
    """The dryrun's sequence-parallel sections (``__graft_entry__.py:203-266``)
    on this rank of a (data, seq) mesh; every rank of the world calls it
    together. CUDA ranks use ``check_config``'s dialect (d_head 32), CPU
    ranks the dryrun's own (d_head 4).

    1. One dp x sp SGD step of the dialect with window None and
       attn_parallel "seq" (seed 4), its loss against the unsharded loss
       of the same weights and tokens within 1e-2; on a CUDA rank at seq
       coordinate c each training kernel launches (c + 1)·n_layers times.
       The batch is the check batch's first rows that split over data, all
       8 unless the data axis does not divide 8 (``seq_mesh_shape``).
    2. Ring attention over a ("seq",) mesh of every rank: q, k, v (2, 2,
       8n, D) against reference_attention within 5e-2, D = 8 (32 on the
       card).
    3. Ring-flash: (2, 2, 16n, D), D = 16 (32 on the card), the same
       check, and the grad of sum(out²) in q finite. The port has one ring
       body, the flash one, so 2 and 3 differ in shapes only.

    Returns {"loss", "loss_unsharded", "loss_err", "launches", "ring_err",
    "ring_flash_err"}."""
    device = mesh.device
    cfg = _dryrun_config(device, window=None, attn_parallel="seq")
    tokens = check_tokens(cfg, mesh.size(mesh.axis_names[0]))
    params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    local = shard_params(params, mesh, cfg)
    reset_kernel_launches()
    _, loss = make_train_step(cfg, mesh=mesh)(local, tokens)
    _sync(device)
    launches = kernel_launches()
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"rank {mesh.rank}: non-finite seq-parallel loss {loss.item()}")
    with torch.no_grad():
        ref = loss_fn(local, tokens.to(device), dataclasses.replace(cfg, attn_parallel="heads"))
    err = abs(loss.item() - ref.item())
    if not err < SHARDED_LOSS_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: seq-parallel first-step loss {loss.item()} vs "
                           f"unsharded {ref.item()} (|d|={err})")
    world = mesh.size(mesh.axis_names[0]) * mesh.size(mesh.axis_names[1])
    seq_mesh = build_mesh((world,), ("seq",), device)
    d_ring, d_flash = (32, 32) if device.type == "cuda" else (8, 16)
    ring = _ring_case(seq_mesh, (2, 2, 8 * world, d_ring), 0, grads=False)
    ring_flash = _ring_case(seq_mesh, (2, 2, 16 * world, d_flash), 1, grads=True)
    return {"loss": loss.item(), "loss_unsharded": ref.item(), "loss_err": err,
            "launches": launches, "ring_err": ring["max_abs_err"],
            "ring_flash_err": ring_flash["max_abs_err"]}


def pipeline_checks(mesh) -> dict:
    """The dryrun's pipeline sections (``__graft_entry__.py:286-336``) on
    this rank of a ("pipe",) mesh of P ranks; every rank calls it together.

    1. GPipe over P stages of tanh(x @ w), w = 0.9·I (16), on ones (8, 16)
       in 4 microbatches: finite, and equal to the stages run in turn
       within 1e-6.
    With P >= 2 (the reference's sections fail below that; one stage has
    no bubble):

    2. The bubble accounting: the interleaved schedule (v 2) has a smaller
       bubble fraction than GPipe's at the same microbatches and stages.
    3. The interleaved flagship: 2 chunks a rank, 2P blocks of the dialect
       (seed 5), n_micro the least multiple of P that is >= 4 (the
       reference's 4 fails for 3 stages), on the first n_micro·⌊8/n_micro⌋
       rows of the check batch: one step, its loss against the unsharded
       loss within 1e-2. On a CUDA rank each training kernel launches
       n_micro·2 times (one block a chunk).

    Returns {"gpipe_err", "bubble": {"gpipe", "interleaved"}, and with P >=
    2 "loss", "loss_unsharded", "loss_err", "n_micro", "launches"}."""
    device = mesh.device
    n_stages = mesh.size(mesh.axis_names[0])
    w = torch.eye(16) * 0.9
    stages = shard_stage_params({"w": torch.stack([w] * n_stages)}, mesh, mesh.axis_names[0])
    x = torch.ones((8, 16), device=device)
    y = pipeline_apply(stages, x, mesh, lambda p, a: torch.tanh(a @ p["w"]), n_micro=4,
                       pipe_axis=mesh.axis_names[0])
    want = x
    for _ in range(n_stages):
        want = torch.tanh(want @ w.to(device))
    gpipe_err = (y - want).abs().max().item()
    if not (torch.isfinite(y).all() and gpipe_err <= 1e-6):
        raise RuntimeError(f"rank {mesh.rank}: GPipe output off by {gpipe_err}")
    n_virtual, n_micro = 2, n_stages * math.ceil(4 / n_stages)
    bubble = {"gpipe": schedule_info(n_micro, n_stages)["bubble_fraction"],
              "interleaved": schedule_info(n_micro, n_stages, n_virtual)["bubble_fraction"]}
    out = {"gpipe_err": gpipe_err, "bubble": bubble}
    if n_stages < 2:  # one stage has no bubble to shrink
        return out
    if not bubble["interleaved"] < bubble["gpipe"]:
        raise RuntimeError(f"interleaving does not shrink the bubble: {bubble}")
    cfg = _dryrun_config(device, n_layers=n_stages * n_virtual)
    tokens = check_tokens(cfg, n_micro)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    local = shard_pipeline_params(to_pipeline_params(params, n_stages, n_virtual), mesh,
                                  mesh.axis_names[0])
    step = make_pipeline_train_step(mesh, cfg, n_micro=n_micro, pipe_axis=mesh.axis_names[0],
                                    n_virtual=n_virtual)
    reset_kernel_launches()
    _, loss = step(local, tokens)
    _sync(device)
    launches = kernel_launches()
    if not math.isfinite(loss.item()):
        raise RuntimeError(f"rank {mesh.rank}: non-finite pipeline loss {loss.item()}")
    with torch.no_grad():
        ref = loss_fn(tree_map(lambda t: t.to(device), params), tokens.to(device), cfg)
    err = abs(loss.item() - ref.item())
    if not err < SHARDED_LOSS_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: pipeline first-step loss {loss.item()} vs "
                           f"unsharded {ref.item()} (|d|={err})")
    return {**out, "loss": loss.item(), "loss_unsharded": ref.item(), "loss_err": err,
            "n_micro": n_micro, "launches": launches}


def _seq_pipeline_rank(shape, device) -> dict:
    seq = seq_checks(build_mesh(shape, ("data", "seq"), device))
    pipe = pipeline_checks(build_mesh((shape[0] * shape[1],), ("pipe",), device))
    return {"rank": torch.distributed.get_rank(), "seq": seq, "pipeline": pipe}


def seq_pipeline_check(n_data: int, n_seq: int, device="cuda", *, backend: str,
                       timeout_s: float = 600.0) -> list[dict]:
    """``seq_checks`` on an (n_data, n_seq) ("data", "seq") mesh, then
    ``pipeline_checks`` on a ("pipe",) mesh of the same n_data·n_seq ranks,
    started as processes (``parallel.launch.run_ranks``) that join a process
    group of `backend`: the counterpart of the dryrun's dp x sp, ring and
    pipeline sections. The caller names the backend; nothing here swaps one
    for another. Runs on the card unless the caller passes device="cpu".
    Returns every rank's results; raises when a rank fails, naming it, or
    when the ranks' losses differ."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    results = run_ranks(_seq_pipeline_rank, n_data * n_seq, backend=backend,
                        args=((n_data, n_seq), device), timeout_s=timeout_s)
    for part in ("seq", "pipeline"):
        losses = {r[part].get("loss") for r in results}
        if len(losses) != 1:
            raise RuntimeError(f"the ranks' {part} losses differ: {sorted(losses)}")
    return results


# --- the hot-add that grows a job's mesh ---


def _timed(fn, device: torch.device) -> tuple:
    """(fn(), host ms from the call to its end on `device`)."""
    _sync(device)
    t0 = time.perf_counter()
    value = fn()
    _sync(device)
    return value, (time.perf_counter() - t0) * 1e3


def _adamw(cfg: TransformerConfig, mesh=None):
    return make_train_step_optim(cfg, lambda ps: torch.optim.AdamW(ps, **GROW_ADAMW), mesh)


def _grow_specs(cfg: TransformerConfig) -> tuple:
    """The spec trees of a packed (params, optimizer state) pair."""
    specs = param_specs(cfg)
    return specs, optimizer_state_specs(specs)


def _moments(opt_tree: dict, params: dict, key: str) -> dict:
    """The optimizer state's `key` ("exp_avg" or "exp_avg_sq") of every
    parameter, as a tree of the params' layout."""
    state = iter([opt_tree["state"][str(i)][key] for i in range(len(tree_leaves(params)))])
    return tree_map(lambda _: next(state), params)


def _bit_equal(what: str, got: dict, want: dict, rank: int) -> None:
    for name, g, w in zip(tree_names(want), tree_leaves(got), tree_leaves(want), strict=True):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g.to(w.device), w):
            raise RuntimeError(f"rank {rank}: {what} {name} is not bit-equal to what it should "
                               f"be ({g.dtype} {tuple(g.shape)} against {w.dtype} "
                               f"{tuple(w.shape)})")


def against_one_process(what: str, new_full: dict, loss: float, want: dict, want_loss: float,
                        loss_atol: float) -> dict:
    """A sharded step's gathered new params and loss against the
    one-process step's (want, want_loss) from the same state: each leaf
    within SHARDED_PARAM_OF_MAX of its max |value|, the loss within
    loss_atol. Returns {"loss_one_process", "loss_err", "worst_param":
    (share of max, leaf)}; raises RuntimeError beyond a limit."""
    worst, bad = (0.0, ""), []
    for leaf, g, w in zip(tree_names(want), tree_leaves(new_full), tree_leaves(want),
                          strict=True):
        share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        worst = max(worst, (share, leaf))
        if not share <= SHARDED_PARAM_OF_MAX:
            bad.append(leaf)
    loss_err = abs(loss - want_loss)
    if bad or not loss_err <= loss_atol:
        raise RuntimeError(f"{what} vs the one-process step: params {bad} beyond "
                           f"{SHARDED_PARAM_OF_MAX} of their max |value| (worst {worst}), loss "
                           f"{loss} vs {want_loss} (limit {loss_atol})")
    return {"loss_one_process": want_loss, "loss_err": loss_err, "worst_param": worst}


def _kind(cfg: TransformerConfig) -> str:
    return "dense" if cfg.n_experts is None else "MoE"


def grow_pack(mesh, cfg: TransformerConfig, params: dict, batches: list, path: str) -> dict:
    """The first world of a mesh-growing hot-add, on this rank of a
    ("data", "model") mesh; every rank calls it together. Shards the whole
    `params` (on the CPU), takes one AdamW step (GROW_ADAMW) a batch
    (numpy tokens), packs the params and the optimizer's state through
    their specs (``HotResumable.pack`` over the mesh: every leaf gathered
    whole on every rank), and rank 0 saves to `path` while the others wait
    at a barrier. The pack and the save are each timed GROW_REPEATS times
    (host ms). Returns {"losses", "launches" (this rank's training kernels
    in the steps), "names" (``tree_leaves`` order), "times": {"pack",
    "save"}, "state" (the packed HotResumable)}."""
    local = shard_params(params, mesh, cfg)
    init_fn, step_fn = _adamw(cfg, mesh)
    opt = init_fn(local)
    reset_kernel_launches()
    losses = []
    for tokens in batches:
        local, opt, loss = step_fn(local, opt, torch.from_numpy(tokens))
        losses.append(loss.item())
    launches = kernel_launches()
    specs = _grow_specs(cfg)
    times = {"pack": [], "save": []}
    for _ in range(GROW_REPEATS):
        state, ms = _timed(lambda: HotResumable.pack(local, optimizer_state_tree(opt),
                                                     specs=specs, mesh=mesh), mesh.device)
        times["pack"].append(ms)
    if mesh.rank == 0:  # one writer: save's flock would serialise every rank's
        for _ in range(GROW_REPEATS):
            times["save"].append(_timed(lambda: state.save(path), mesh.device)[1])
    dist.barrier()
    return {"losses": losses, "launches": launches, "names": tree_names(local),
            "times": times, "state": state}


def _one_process_step(state: HotResumable, cfg: TransformerConfig, tokens: np.ndarray,
                      grads: dict, device: torch.device) -> tuple:
    """In this process, from the packed state whole on `device`: the loss of
    the params on `tokens`, and one AdamW update of the params with the
    given whole `grads` (the state's optimizer, loaded as
    ``load_optimizer_state`` does). Returns (new params, loss)."""
    params, opt_tree = state.restore(device)
    with torch.no_grad():
        loss = loss_fn(params, torch.from_numpy(tokens).to(device), cfg).item()
    init_fn, _ = _adamw(cfg)
    opt = init_fn(params)
    load_optimizer_state(opt, opt_tree)
    for leaf, grad in zip(tree_leaves(params), tree_leaves(grads), strict=True):
        leaf.grad = grad
    opt.step()
    return params, loss


def grow_restore(mesh, cfg: TransformerConfig, batches: list, path: str) -> dict:
    """The second world of a mesh-growing hot-add, on this rank of the new
    ("data", "model") mesh; every rank calls it together. Loads the
    checkpoint at `path` and restores this rank's shards of the params and
    the optimizer's state (``HotResumable.restore`` with specs on the
    mesh), and raises unless they are bit-equal to ``shard_params`` of the
    packed whole params and moments, and the params gathered again
    bit-equal to the packed ones. Then builds AdamW over the shards, loads
    the state (each moment bit-equal to its restored shard) and takes one
    step a batch. The first step is held against one process from the
    same state on rank 0's device (``against_one_process``): its loss
    against the whole params' loss (ONE_PROCESS_LOSS_ATOL), and its
    gathered new params against the whole optimizer's update with the
    step's gathered gradients (SHARDED_PARAM_OF_MAX): the restored state
    must give the update one process gives. The gradients themselves are
    the sharded step's, which ``tp_checks`` and ``sharded_step_check`` hold
    (a whole AdamW step of its own would differ wherever a top-1 route
    flips between the two runs, since AdamW scales each element's update to
    about lr whatever its gradient). Load, restore and the
    optimizer's state are each timed GROW_REPEATS times, the first step
    once (host ms). Returns {"losses", "launches" (this rank's training
    kernels in its steps), "names", "times": {"load", "restore",
    "optimizer", "first_step"}, "one_process" (rank 0's comparison, else
    {}), "local" (the new shards)}."""
    device, rank = mesh.device, mesh.rank
    times = {"load": [], "restore": [], "optimizer": []}
    for _ in range(GROW_REPEATS):
        state, ms = _timed(lambda: HotResumable.load(path), device)
        times["load"].append(ms)
    specs = _grow_specs(cfg)
    for _ in range(GROW_REPEATS):
        (local, opt_tree), ms = _timed(lambda: state.restore(specs=specs, mesh=mesh), device)
        times["restore"].append(ms)
    whole, whole_opt = state.host_state
    _bit_equal("restored params", local, shard_params(whole, mesh, cfg), rank)
    for key in ("exp_avg", "exp_avg_sq"):
        _bit_equal(f"restored {key}", _moments(opt_tree, local, key),
                   shard_params(_moments(whole_opt, whole, key), mesh, cfg), rank)
    _bit_equal("gathered restored params", gather_params(local, mesh, cfg), whole, rank)

    init_fn, step_fn = _adamw(cfg, mesh)

    def optimizer():
        opt = init_fn(local)
        load_optimizer_state(opt, opt_tree)
        return opt

    for _ in range(GROW_REPEATS):
        opt, ms = _timed(optimizer, device)
        times["optimizer"].append(ms)
    for key in ("exp_avg", "exp_avg_sq"):
        loaded = tree_map(lambda leaf: opt.state[leaf][key], local)
        _bit_equal(f"loaded {key}", loaded, _moments(opt_tree, local, key), rank)

    reset_kernel_launches()
    (local, opt, loss), times["first_step"] = _timed(
        lambda: step_fn(local, opt, torch.from_numpy(batches[0])), device)
    launches = kernel_launches()
    losses = [loss.item()]
    new_whole = gather_params(local, mesh, cfg)
    grads = gather_params(tree_map(lambda leaf: leaf.grad, local), mesh, cfg)
    one_process = {}
    if rank == 0:
        want, want_loss = _one_process_step(state, cfg, batches[0], grads, device)
        one_process = against_one_process(f"rank 0: the grown {_kind(cfg)} world's first step",
                                          new_whole, losses[0], want, want_loss,
                                          ONE_PROCESS_LOSS_ATOL[_kind(cfg)])
    del new_whole, grads
    reset_kernel_launches()
    for tokens in batches[1:]:
        local, opt, loss = step_fn(local, opt, torch.from_numpy(tokens))
        losses.append(loss.item())
    launches = {k: v + kernel_launches()[k] for k, v in launches.items()}
    return {"losses": losses, "launches": launches, "names": tree_names(local), "times": times,
            "one_process": one_process, "local": local}


def _grow_rank_a(shape, device, cfg, path, batches) -> dict:
    mesh = build_mesh(shape, device=device)
    params = init_params(cfg, torch.Generator().manual_seed(GROW_SEED), "cpu")
    out = grow_pack(mesh, cfg, params, batches, path)
    del out["state"]
    return {"rank": mesh.rank, **out}


def _grow_rank_b(shape, device, cfg, path, batches) -> dict:
    entered = time.time()
    mesh = build_mesh(shape, device=device)
    out = grow_restore(mesh, cfg, batches, path)
    del out["local"]
    return {"rank": mesh.rank, "entered": entered, **out}


def grow_check(old_shape: tuple, new_shape: tuple, device="cuda", *, backend: str, path: str,
               cfg: TransformerConfig | None = None, steps: tuple = (2, 2),
               batch: tuple = DRYRUN_TOKENS, timeout_s: float = 600.0) -> dict:
    """The hot-add that grows a training job's mesh: the port's form of the
    reference's ``test_hot_resume_grows_mesh`` (4 -> 8 chips), with the
    optimizer. A hot-add is a new process image in the port
    (``torchside.visibility.handoff``); for a job of several ranks that is
    a new world.

    1. World A: prod(old_shape) ranks (``parallel.launch.run_ranks``, a
       process group of `backend`) on an old_shape ("data", "model") mesh,
       each running ``grow_pack``: the seeded whole params of cfg
       (default ``check_config()``), steps[0] AdamW steps (lr 1e-3, weight
       decay 1e-4), the pack, rank 0's save to `path`. The processes exit.
    2. World B: prod(new_shape) ranks on a new_shape mesh, each running
       ``grow_restore``: load, restore its shards, hold them bit-equal,
       load the optimizer's state, steps[1] more steps, the first held
       against the one-process step.
    3. Every rank's losses equal in each world, and both worlds'
       ``tree_leaves`` order the same (the optimizer's state is keyed by
       it).

    Batches: numpy tokens of shape `batch` from seed GROW_SEED, one a
    step. The caller names the backend; nothing here swaps one for another.
    Runs on the card unless the caller passes device="cpu". Returns {"old":
    world A's per-rank results, "new": world B's, "start_s": host s from
    world B's spawn to its last rank's entry (processes, imports and the
    process group's set-up)}; raises when a check fails or a rank fails,
    naming it."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    if min(steps) < 1:
        raise ValueError(f"steps {steps}: each world takes at least one step")
    cfg = cfg if cfg is not None else check_config()
    rng = np.random.default_rng(GROW_SEED)
    batches = [rng.integers(0, cfg.vocab, batch) for _ in range(sum(steps))]
    old = run_ranks(_grow_rank_a, math.prod(old_shape), backend=backend,
                    args=(tuple(old_shape), device, cfg, path, batches[:steps[0]]),
                    timeout_s=timeout_s)
    spawned = time.time()
    new = run_ranks(_grow_rank_b, math.prod(new_shape), backend=backend,
                    args=(tuple(new_shape), device, cfg, path, batches[steps[0]:]),
                    timeout_s=timeout_s)
    for world, results in (("old", old), ("new", new)):
        if len({tuple(r["losses"]) for r in results}) != 1:
            raise RuntimeError(f"the {world} world's ranks' losses differ: "
                               f"{[r['losses'] for r in results]}")
    if old[0]["names"] != new[0]["names"]:
        raise RuntimeError(f"the worlds order the leaves differently: {old[0]['names']} "
                           f"against {new[0]['names']}")
    return {"old": old, "new": new, "start_s": max(r["entered"] for r in new) - spawned}


# --- the reference's multichip dryrun ---


def seq_mesh_shape(n: int) -> tuple[int, int]:
    """The dryrun's (data, seq) mesh for n ranks. The reference's is (dsp,
    n/dsp), dsp 2 for even n >= 4, else 1 (``__graft_entry__.py:207``);
    where n/dsp does not divide the 16 tokens of a row (n 3, 5, 6, 7) its
    section fails. There the port takes the largest seq axis that divides
    both n and 16, gcd(n, 16), and puts the rest on data: (3, 2) for n 6.
    ``seq_checks`` then runs the check batch's first rows that split over
    data (6 of 8 at n 6)."""
    dsp = 2 if n % 2 == 0 and n >= 4 else 1
    if DRYRUN_TOKENS[1] % (n // dsp) == 0:
        return dsp, n // dsp
    seq = math.gcd(n, DRYRUN_TOKENS[1])
    return n // seq, seq


def _section(name: str, fn, *args):
    """fn(*args); a failure is raised again naming the dryrun's section and
    this rank."""
    try:
        return fn(*args)
    except Exception as err:
        raise RuntimeError(f"dryrun section {name} failed on rank {dist.get_rank()}: "
                           f"{type(err).__name__}: {err}") from err


def _dryrun_rank(n: int, device) -> dict:
    out = {"rank": dist.get_rank()}
    out["tp"] = _section("tp_checks", lambda: tp_checks(build_mesh(device=device)))
    out["seq"] = _section("seq_checks", lambda: seq_checks(
        build_mesh(seq_mesh_shape(n), ("data", "seq"), device)))
    pipe = build_mesh((min(4, n),), ("pipe",), device)
    out["pipeline"] = None if pipe is None else _section("pipeline_checks", pipeline_checks, pipe)
    return out


def stretch_check(mesh, cfg: TransformerConfig, params: dict, tokens: torch.Tensor) -> dict:
    """The dryrun's stretch on this rank: one ``sharded_step_check`` of the
    whole `params` over `mesh`, its loss against the unsharded loss
    (``loss_fn`` of the whole params and batch in this one process) within
    SHARDED_LOSS_ATOL. Returns sharded_step_check's results with
    "loss_unsharded" and "loss_err"."""
    result = sharded_step_check(cfg, mesh, params, tokens)
    with torch.no_grad():
        ref = loss_fn(tree_map(lambda t: t.to(mesh.device), params), tokens.to(mesh.device),
                      cfg).item()
    err = abs(result["loss"] - ref)
    if not err < SHARDED_LOSS_ATOL:
        raise RuntimeError(f"rank {mesh.rank}: stretch loss {result['loss']} vs unsharded "
                           f"{ref} (|d|={err})")
    return {**result, "loss_unsharded": ref, "loss_err": err}


def _stretch_rank(plan, device) -> dict:
    mesh = build_mesh(plan.mesh_shape, plan.mesh_axes, device)
    cfg = _dryrun_config(mesh.device)
    params = init_params(cfg, torch.Generator().manual_seed(STRETCH["SEED"]), "cpu")
    result = _section("stretch", stretch_check, mesh, cfg, params, check_tokens(cfg))
    del result["local"]
    return {"rank": mesh.rank, "coords": dict(mesh.coords), **result}


def dryrun_multichip(n: int, device="cuda", *, backend: str, timeout_s: float = 600.0) -> dict:
    """The counterpart of the reference's ``dryrun_multichip(n)``
    (``__graft_entry__.py:110-336``), over processes joined by a process
    group of `backend`, in two spawns (``parallel.launch.run_ranks``), each
    with its own time limit.

    1. n ranks, each running the reference's sections on its meshes for n:
       ``tp_checks`` on ``build_mesh()`` (``mesh_shape_for(n)``: the dp x
       tp step, its grads through the kernels against the plain
       attention's, the MoE flagship, ``make_moe_step`` over (data,
       expert)); ``seq_checks`` on ``seq_mesh_shape(n)``; and
       ``pipeline_checks`` on a ("pipe",) mesh of the first min(4, n)
       ranks.
    2. The stretch: the reference's v5litepod-16 run, laid out by the H100
       plan ``topology.lookup("nvidia-h100-80gb", 16)``: 16 ranks on a (2,
       8) (data, model) mesh, hosts on data and a host's GPUs on model,
       each running ``stretch_check`` of ``_dryrun_config`` (seed 2).

    The reference's check against involuntary rematerialisation belongs to
    GSPMD's compiler; its counterpart is ``sharded_step_check``'s in every
    dp x tp step: the collectives of each step are ``step_collectives``',
    no weight is gathered, and the replicas are bit-equal.

    The caller names the backend; nothing here swaps one for another. Runs
    on the card unless the caller passes device="cpu". Returns {"sections":
    every rank's {"rank", "tp", "seq", "pipeline" (None outside the pipe
    mesh)}, "stretch": every rank's, "seq_shape", "pipe_stages", "plan",
    "seconds": {"sections", "stretch"} (host s of each spawn, the ranks'
    start included)}; raises, naming the section and the rank, when a
    check fails, and when a section's ranks' losses differ."""
    if torch.device(device).type == "cuda":
        resolve_device(device)
    t0 = time.perf_counter()
    sections = run_ranks(_dryrun_rank, n, backend=backend, args=(n, device),
                         timeout_s=timeout_s)
    t1 = time.perf_counter()
    plan = lookup(STRETCH["ACCEL"], STRETCH["GPUS"])
    stretch = run_ranks(_stretch_rank, plan.total_gpus, backend=backend, args=(plan, device),
                        timeout_s=timeout_s)
    t2 = time.perf_counter()
    for name, losses in (
            ("tp_checks", [r["tp"]["loss"] for r in sections]),
            ("seq_checks", [r["seq"]["loss"] for r in sections]),
            ("pipeline_checks", [r["pipeline"].get("loss") for r in sections
                                 if r["pipeline"] is not None]),
            ("stretch", [r["loss"] for r in stretch])):
        if len(set(losses)) != 1:
            raise RuntimeError(f"dryrun section {name}: the ranks' losses differ: {losses}")
    return {"sections": sections, "stretch": stretch, "seq_shape": seq_mesh_shape(n),
            "pipe_stages": min(4, n), "plan": plan,
            "seconds": {"sections": t1 - t0, "stretch": t2 - t1}}
