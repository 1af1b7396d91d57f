"""Rank bodies for the port's sharded tests on the CPU.

``parallel.launch.run_ranks`` starts each rank as a fresh process, which
imports the function it runs by name; this module imports torch and the
port only, so that a rank does not import JAX. Inputs come from the test
as numpy trees (the reference's weights) and plain values, and each rank
returns numpy arrays and Python values.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from gpumounter_tpu_torch.models.probe import TransformerConfig, forward
from gpumounter_tpu_torch.parallel import collectives
from gpumounter_tpu_torch.parallel.mesh import build_mesh, gather_leaf, shard_qkv, shard_tokens
from gpumounter_tpu_torch.parallel.moe import make_moe_step, moe_param_specs, shard_moe_params
from gpumounter_tpu_torch.parallel.pipeline import pipeline_apply, shard_stage_params
from gpumounter_tpu_torch.parallel.pipeline_train import (make_pipeline_train_step,
                                                          shard_pipeline_params,
                                                          to_pipeline_params)
from gpumounter_tpu_torch.parallel.ring_attention import ring_attention
from gpumounter_tpu_torch.parallel.tp_attention import tp_flash_attention
from gpumounter_tpu_torch.parallel.train_step import (gather_params, make_train_step,
                                                      make_train_step_optim, shard_params,
                                                      tree_leaves, tree_map)
from gpumounter_tpu_torch.weights import params_from_jax


def config(fields: dict) -> TransformerConfig:
    """A TransformerConfig from fields with the dtype named as a string."""
    return TransformerConfig(**{**fields, "dtype": getattr(torch, fields["dtype"])})


def _numpy(params: dict) -> dict:
    return tree_map(lambda t: t.detach().float().numpy(), params)


def _counts(mesh) -> dict:
    return {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}


def _run_train(mesh, kind, fields, tree, batches, lr=None, adamw=None, single=False):
    """One case of a sharded train step: the gathered new params, the
    losses, the shapes of this rank's shards, and the collectives of the
    last step; with single, also the port's one-device step on the full
    params."""
    cfg = config(fields)
    full = params_from_jax(tree, cfg, "cpu")
    local = shard_params(full, mesh, cfg)
    shapes = [tuple(t.shape) for t in tree_leaves(local)]
    losses = []
    if kind == "sgd":
        step = make_train_step(cfg, lr=lr, mesh=mesh)
        for tokens in batches:
            mesh.reset_counts()
            local, loss = step(local, torch.from_numpy(tokens))
            losses.append(loss.item())
    else:
        init_fn, step_fn = make_train_step_optim(
            cfg, lambda ps: torch.optim.AdamW(ps, **adamw), mesh=mesh)
        opt = init_fn(local)
        for tokens in batches:
            mesh.reset_counts()
            local, opt, loss = step_fn(local, opt, torch.from_numpy(tokens))
            losses.append(loss.item())
    out = {"losses": losses, "shapes": shapes, "counts": _counts(mesh),
           "params": _numpy(gather_params(local, mesh, cfg))}
    if single:
        step = make_train_step(cfg, lr=lr)
        for tokens in batches:
            full, loss = step(full, torch.from_numpy(tokens))
        out["single"] = {"params": _numpy(full), "loss": loss.item()}
    return out


def _run_moe_step(mesh, n_experts, d_model, d_ff, lr, tree, x, target, steps):
    """make_moe_step over the ("data", "expert") mesh: the gathered params
    after each step, the losses, and the last step's collectives."""
    step = make_moe_step(n_experts, d_model, d_ff, lr=lr, mesh=mesh)
    specs = moe_param_specs()
    dtype = getattr(torch, tree.pop("dtype"))
    params = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else dtype)
              for k, v in tree.items()}
    local = shard_moe_params(params, mesh)
    x, target = (torch.from_numpy(a).to(dtype) for a in (x, target))
    losses, gathered = [], []
    for _ in range(steps):
        mesh.reset_counts()
        local, loss = step(local, x, target)
        losses.append(loss.item())
        counts = _counts(mesh)
        gathered.append({k: gather_leaf(v, specs[k], mesh).float().numpy()
                         for k, v in local.items()})
    return {"losses": losses, "params": gathered, "counts": counts}


def train_cases(shape, cases: dict) -> dict:
    """Every case of a test module on one mesh of this shape."""
    torch.set_num_threads(1)
    mesh = build_mesh(shape, device="cpu")
    out = {}
    for name, case in cases.items():
        if case["kind"] == "moe_step":
            expert_mesh = build_mesh(case.pop("expert_shape"), ("data", "expert"), "cpu")
            out[name] = _run_moe_step(expert_mesh, **{k: v for k, v in case.items()
                                                      if k != "kind"})
        else:
            out[name] = _run_train(mesh, **case)
    return out


def mesh_cases(shape, qkv) -> dict:
    """The mesh's layout, f and g on grads, the counts, and
    tp_flash_attention's output on this rank's heads of q, k, v."""
    torch.set_num_threads(1)
    mesh = build_mesh(shape, device="cpu")
    rank = torch.tensor([float(dist.get_rank())])
    out = {"coords": dict(mesh.coords), "device": str(mesh.device),
           "axis_ranks": {axis: [int(t.item()) for t in collectives.all_gather(rank, mesh, axis)]
                          for axis in mesh.axis_names}}
    model, n = mesh.axis_names[1], mesh.size(mesh.axis_names[1])
    scale = float(mesh.coord(model) + 1)

    x = torch.ones(3, requires_grad=True)
    (collectives.reduce_from(2 * x, mesh, model) * scale).sum().backward()
    out["g_grad"] = x.grad.tolist()  # identity backward: the local 2·scale
    x = torch.ones(3, requires_grad=True)
    y = collectives.reduce_from(2 * x, mesh, model)
    out["g_value"] = y.tolist()  # 2·n
    x = torch.ones(3, requires_grad=True)
    (collectives.copy_to(x, mesh, model) * scale).sum().backward()
    out["f_grad"] = x.grad.tolist()  # the sum of the scales over the axis
    x = torch.ones(3, requires_grad=True)
    from torch.distributed.nn.functional import all_reduce as library_all_reduce
    library_all_reduce(2 * x, group=mesh.groups[model]).sum().backward()
    out["library_all_reduce_grad"] = x.grad.tolist()
    mesh.reset_counts()
    collectives.all_reduce(torch.ones(5, dtype=torch.bfloat16), mesh, model)
    collectives.all_gather(torch.ones(2, 3), mesh, mesh.axis_names[0])
    out["counts"] = _counts(mesh)
    q, k, v = (torch.from_numpy(a) for a in qkv)
    out["tp_attention"] = tp_flash_attention(q, k, v, mesh, window=3).numpy()
    out["model_size"] = n
    return out


def fail_on(rank: int) -> int:
    """Raises on `rank`; the others wait at a barrier it never reaches."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def hang_on(rank: int) -> int:
    """`rank` never returns."""
    if dist.get_rank() == rank:
        time.sleep(3600)
    return dist.get_rank()


def ring_cases(n: int, cases: dict) -> dict:
    """On a ("seq",) mesh of n ranks: ring_shift's values, gradients and
    counts, then each ring attention case on this rank's chunks of the
    whole q, k, v (numpy): its output chunk and the gradients of
    sum(out · do) in its q, k and v chunks."""
    torch.set_num_threads(1)
    mesh = build_mesh((n,), ("seq",), "cpu")
    c = mesh.coord("seq")
    a = torch.full((3,), float(c), requires_grad=True)
    b = torch.full((2, 2), 10.0 * c, dtype=torch.float64, requires_grad=True)
    mesh.reset_counts()
    ra, rb = collectives.ring_shift((a * 1, b * 1), mesh, "seq")
    weight = float(c + 1)
    ga, gb = torch.autograd.grad((ra * weight).sum() + rb.sum(), [a, b])
    out = {"shift": {"received": [ra.tolist(), rb.tolist()], "grads": [ga.tolist(), gb.tolist()],
                     "counts": _counts(mesh), "sent": dict(mesh.sent)}}
    for name, case in cases.items():
        q, k, v, do = (shard_qkv(torch.from_numpy(x), mesh) for x in case["qkv_do"])
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        mesh.reset_counts()
        o = ring_attention(q, k, v, mesh, causal=case["causal"], softcap=case["softcap"])
        grads = torch.autograd.grad((o * do).sum(), [q, k, v])
        out[name] = {"out": o.detach().numpy(), "grads": [g.numpy() for g in grads],
                     "counts": _counts(mesh)}
    return out


def seq_train_cases(shape, cases: dict) -> dict:
    """Every dp x sp case on a (data, seq) mesh of this shape: the losses,
    the new params (whole on every rank), the collectives of the last step
    against ``step_collectives``' formula."""
    from gpumounter_tpu_torch.parallel.train_step import step_collectives
    torch.set_num_threads(1)
    mesh = build_mesh(shape, ("data", "seq"), device="cpu")
    out = {}
    for name, case in cases.items():
        cfg = config(case["fields"])
        local = shard_params(params_from_jax(case["tree"], cfg, "cpu"), mesh, cfg)
        tokens = torch.from_numpy(case["batches"][0])
        logits = forward(local, shard_tokens(tokens, mesh, seq=True), cfg, mesh=mesh)
        result = _run_train(mesh, **case)
        result["logits"] = logits.detach().numpy()
        result["counts_formula"] = step_collectives(cfg, mesh, local, tokens.shape)
        out[name] = result
    return out


def pipeline_cases(cases: dict) -> dict:
    """On a ("pipe",) mesh of every rank: pipeline_apply on tanh(x @ w)
    stages (its output, and the gradients of sum(y²) in this rank's stage
    block and in x), and make_pipeline_train_step's steps (the losses and
    this rank's new params, its block of the stages)."""
    torch.set_num_threads(1)
    mesh = build_mesh((dist.get_world_size(),), ("pipe",), "cpu")
    out = {}
    for name, case in cases.items():
        if case["kind"] == "apply":
            stages = shard_stage_params({"w": torch.from_numpy(case["w"])}, mesh)
            stages["w"].requires_grad_()
            x = torch.from_numpy(case["x"]).requires_grad_()
            mesh.reset_counts()
            y = pipeline_apply(stages, x, mesh, lambda p, a: torch.tanh(a @ p["w"]),
                               n_micro=case["n_micro"], n_virtual=case["n_virtual"])
            gw, gx = torch.autograd.grad(y.square().sum(), [stages["w"], x])
            out[name] = {"y": y.detach().numpy(), "gw": gw.numpy(), "gx": gx.numpy(),
                         "counts": _counts(mesh)}
            continue
        cfg = config(case["fields"])
        n_stages, v = mesh.size("pipe"), case["n_virtual"]
        params = shard_pipeline_params(to_pipeline_params(
            params_from_jax(case["tree"], cfg, "cpu"), n_stages, v), mesh)
        step = make_pipeline_train_step(mesh, cfg, case["n_micro"], lr=case["lr"], n_virtual=v)
        losses = []
        for tokens in case["batches"]:
            params, loss = step(params, torch.from_numpy(tokens))
            losses.append(loss.item())
        out[name] = {"losses": losses, "params": _numpy(params)}
    return out


def pipeline_checks_rank() -> dict:
    """entry.pipeline_checks on a ("pipe",) mesh of every rank."""
    from gpumounter_tpu_torch.entry import pipeline_checks
    torch.set_num_threads(1)
    return pipeline_checks(build_mesh((dist.get_world_size(),), ("pipe",), "cpu"))


def _state_numpy(state) -> dict:
    """A packed (params, optimizer state) pair as numpy: the params, and
    each moment as a list in ``tree_leaves`` order."""
    params, opt = state.host_state
    n = len(tree_leaves(params))
    return {"params": _numpy(params),
            **{key: [opt["state"][str(i)][key].numpy() for i in range(n)]
               for key in ("exp_avg", "exp_avg_sq")}}


def grow_world_a(shape, cases: dict, root: str) -> dict:
    """The first world of each grow case on a ("data", "model") mesh of this
    shape: ``entry.grow_pack`` of the reference's weights over the case's
    first batches, saved to root/<case>; the losses, the leaf names and the
    packed whole state (numpy)."""
    from gpumounter_tpu_torch.entry import grow_pack
    torch.set_num_threads(1)
    mesh = build_mesh(shape, device="cpu")
    out = {}
    for name, case in cases.items():
        cfg = config(case["fields"])
        full = params_from_jax(case["tree"], cfg, "cpu")
        result = grow_pack(mesh, cfg, full, case["before"], f"{root}/{name}")
        out[name] = {"losses": result["losses"], "names": result["names"],
                     "packed": _state_numpy(result["state"])}
    return out


def grow_world_b(shape, cases: dict, root: str) -> dict:
    """The second world of each grow case on a ("data", "model") mesh of
    this shape: ``entry.grow_restore`` from root/<case> over the case's
    last batches (it raises unless the restored shards and the gathered
    params are bit-equal to what was packed); the losses, the leaf names,
    the gathered params after the steps and rank 0's one-process
    comparison. Then the reference's initial weights packed whole and
    restored with ``param_specs`` onto this mesh: whether every shard
    equals ``shard_params``', the params gathered again, and each block's
    wqkv shard (numpy)."""
    from gpumounter_tpu_torch.entry import grow_restore
    from gpumounter_tpu_torch.parallel.train_step import param_specs
    from gpumounter_tpu_torch.torchside.resume import HotResumable
    torch.set_num_threads(1)
    mesh = build_mesh(shape, device="cpu")
    out = {}
    for name, case in cases.items():
        cfg = config(case["fields"])
        result = grow_restore(mesh, cfg, case["after"], f"{root}/{name}")
        full = params_from_jax(case["tree"], cfg, "cpu")
        (local,) = HotResumable.pack(full).restore(specs=(param_specs(cfg),), mesh=mesh)
        want = shard_params(full, mesh, cfg)
        out[name] = {
            "losses": result["losses"], "names": result["names"],
            "one_process": result["one_process"],
            "params": _numpy(gather_params(result["local"], mesh, cfg)),
            "init_shards_equal": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(local), tree_leaves(want), strict=True)),
            "init_gathered": _numpy(gather_params(local, mesh, cfg)),
            "wqkv": [blk["wqkv"].numpy() for blk in local["blocks"]],
            "coords": dict(mesh.coords)}
    return out


def stretch_rank(cases: dict) -> dict:
    """``entry.stretch_check`` of each case on the H100 plan's (2, 8)
    ("data", "model") mesh of 16 ranks: the loss, the unsharded loss and
    the gathered new params (numpy)."""
    from gpumounter_tpu_torch.entry import STRETCH, stretch_check
    from gpumounter_tpu_torch.topology import lookup
    torch.set_num_threads(1)
    plan = lookup(STRETCH["ACCEL"], STRETCH["GPUS"])
    mesh = build_mesh(plan.mesh_shape, plan.mesh_axes, "cpu")
    out = {}
    for name, case in cases.items():
        cfg = config(case["fields"])
        result = stretch_check(mesh, cfg, params_from_jax(case["tree"], cfg, "cpu"),
                               torch.from_numpy(case["tokens"]))
        out[name] = {"loss": result["loss"], "loss_unsharded": result["loss_unsharded"],
                     "params": _numpy(gather_params(result["local"], mesh, cfg)),
                     "collectives": result["collectives"]}
    return out


def dryrun_sections_rank(n: int) -> dict:
    """The dryrun's sections (``entry._dryrun_rank``) on n CPU ranks."""
    from gpumounter_tpu_torch.entry import _dryrun_rank
    torch.set_num_threads(1)
    return _dryrun_rank(n, "cpu")
