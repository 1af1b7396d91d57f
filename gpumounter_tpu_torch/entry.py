"""Entry points: the probe's forward, as ``__graft_entry__.entry()`` gives
it, and the training checks of the reference's dryrun, dense
(``train_check``), MoE (``moe_check``) and sharded over a mesh of ranks:
dp x tp and expert parallelism (``tp_train_check``), dp x sp with ring
attention and the pipelines (``seq_pipeline_check``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

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
from gpumounter_tpu_torch.parallel.train_step import (loss_and_grads, make_train_step,
                                                      param_specs, shard_params,
                                                      step_collectives, tree_leaves, tree_map)

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


def check_tokens(cfg) -> torch.Tensor:
    """The checks' batch: tokens (8, 16) from numpy seed 0, on the CPU."""
    return torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (8, 16)))


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
    names = [k for k in sorted(local) if k != "blocks"] + [
        f"blocks[{i}].{k}" for i, blk in enumerate(local["blocks"]) for k in sorted(blk)]
    for name, leaf in zip(names, tree_leaves(local), strict=True):
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
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
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

    Returns {"loss", "max_grad_err", "heads", "launches", "collectives",
    "moe_loss", "moe_launches", "moe_collectives", "moe_step_losses"}."""
    cfg = check_config()
    tokens = check_tokens(cfg)
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
    xs = torch.ones((8, 32), dtype=torch.bfloat16)
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
    tokens = check_tokens(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    local = shard_params(params, mesh, cfg)
    reset_kernel_launches()
    _, loss = make_train_step(cfg, mesh=mesh)(local, tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
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
    tokens = check_tokens(cfg)[:n_micro * (8 // n_micro)]
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    local = shard_pipeline_params(to_pipeline_params(params, n_stages, n_virtual), mesh,
                                  mesh.axis_names[0])
    step = make_pipeline_train_step(mesh, cfg, n_micro=n_micro, pipe_axis=mesh.axis_names[0],
                                    n_virtual=n_virtual)
    reset_kernel_launches()
    _, loss = step(local, tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
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
