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

from gpumounter_tpu_torch.models.probe import TransformerConfig
from gpumounter_tpu_torch.parallel import collectives
from gpumounter_tpu_torch.parallel.mesh import build_mesh, gather_leaf
from gpumounter_tpu_torch.parallel.moe import make_moe_step, moe_param_specs, shard_moe_params
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
