"""Switch-style top-1 Mixture-of-Experts FFN, with expert parallelism.

Counterpart of ``gpumounter_tpu/parallel/moe.py``: a router in float32
picks one expert per token, and the layer is the reference's dense one-hot
dispatch and combine, every expert run on every token (capacity-less, so
shapes stay static). Its products are ``torch.einsum`` on cuBLAS; the
reference also computes them outside any Pallas kernel, so no hand-written
kernel belongs here.

Nothing on the path reads a device value on the host and no shape depends
on the routing, so a decode step through an MoE block can still be
captured as one CUDA graph. ``moe_ffn_plain`` gathers each expert's tokens
by index instead: it is the formulation the dispatch is checked against,
and runs on no path.

Expert parallelism: under a ``parallel.mesh.Mesh`` each rank holds the
whole router and its own slice of the experts (``shard_moe_params``), and
sees every token of its rows of the batch. It dispatches each of them to
its own experts only, with the reference's one-hot einsums limited to
those experts, and the combine is summed over the expert axis (Megatron's
g): each token's one expert sits on one rank, and the others add zeros.
Where the reference lets GSPMD sum over its sharded expert dimension, the
port states the sum. Routing, the gate and the aux loss are computed whole
on every rank; the aux loss takes each expert's routed fraction over the
whole batch (one all-reduce over the data axis).

In the probe's seq layout (a (data, seq) mesh, ``axis=None``) every rank
holds every expert and its own tokens, split over both axes: the routed
fractions are averaged over data and over seq (one all-reduce each) before
their product with the rank's mean probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.parallel.collectives import (all_reduce, copy_to, mean_over_data,
                                                       reduce_from)
from gpumounter_tpu_torch.parallel.mesh import shard_batch, shard_leaf


def init_moe_params(generator: torch.Generator, n_experts: int, d_model: int,
                    d_ff: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Router (d_model, E) in float32 whatever `dtype` is; w1 (E, d_model,
    d_ff) and w2 (E, d_ff, d_model) in `dtype`; all N(0, 0.02²), drawn from
    `generator` on its own device and moved to `device`."""
    device = resolve_device(device)

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * 0.02).to(device)

    return {"router": normal(d_model, n_experts),
            "w1": normal(n_experts, d_model, d_ff).to(dtype),
            "w2": normal(n_experts, d_ff, d_model).to(dtype)}


def moe_param_specs(axis: str = "expert") -> dict:
    """Expert dim split over `axis`; router replicated. The standalone MoE
    step uses a dedicated "expert" mesh axis; the flagship probe rides the
    tensor-parallel "model" axis instead (``train_step.param_specs``)."""
    return {"router": (None, None), "w1": (axis, None, None), "w2": (axis, None, None)}


def shard_moe_params(params: dict, mesh, axis: str = "expert") -> dict:
    """This rank's shards of ``init_moe_params``'s dict, on the mesh's
    device: the whole router, its slice of the experts."""
    specs = moe_param_specs(axis)
    return {key: shard_leaf(value, specs[key], mesh) for key, value in params.items()}


def _route(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(expert index (T,), router probabilities (T, E) in float32) for
    tokens x (T, d_model): the logits are x in float32 times the router."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    return probs.argmax(dim=-1), probs


def moe_ffn(params: dict, x: torch.Tensor, mesh=None,
            axis: str = "expert") -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routed FFN of tokens x (T, d_model): (output (T, d_model) in
    x's dtype, the Switch load-balancing loss, 0-dim float32).

    The reference's steps in its order and dtypes: the one-hot and the gate
    in x's dtype, dispatch te,td->etd, the expert products, tanh GELU,
    combine etd,te->td, then times the gate. Gradients reach the router
    through the gate and the aux loss's mean probability only.

    mesh: this rank's experts are its shard along `axis`, x its tokens;
    the combine is summed over `axis` before the gate, and the routed
    fractions are averaged over every other axis of the mesh (those that
    split the tokens: the data axis, and in the seq layout, where `axis` is
    None and no axis splits the experts, the seq axis too), so the aux
    loss's mean over the ranks is the whole batch's.
    """
    n_experts = params["router"].shape[1]
    expert_idx, probs = _route(params, x)
    # A comparison, not F.one_hot, whose value checks read the device.
    onehot = (expert_idx[:, None] == torch.arange(n_experts, device=x.device)).to(x.dtype)
    gate = probs.gather(1, expert_idx[:, None]).to(x.dtype)
    mine = onehot
    if mesh is not None and axis is not None:
        n_local = params["w1"].shape[0]
        if n_local * mesh.size(axis) != n_experts:
            raise ValueError(f"{n_local} experts a rank over the {axis!r} axis of size "
                             f"{mesh.size(axis)} are not the router's {n_experts}")
        mine = onehot[:, mesh.coord(axis) * n_local:][:, :n_local]
    dispatched = torch.einsum("te,td->etd", mine, copy_to(x, mesh, axis))
    h = F.gelu(torch.einsum("etd,edf->etf", dispatched, params["w1"]), approximate="tanh")
    out_e = torch.einsum("etf,efd->etd", h, params["w2"])
    combined = reduce_from(torch.einsum("etd,te->td", out_e, mine), mesh, axis) * gate
    frac = onehot.float().mean(dim=0)
    if mesh is not None:
        for other in mesh.axis_names:
            if other != axis:
                frac = all_reduce(frac, mesh, other) / mesh.size(other)
    aux = n_experts * (frac * probs.mean(dim=0)).sum()
    return combined, aux


def moe_ffn_plain(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``moe_ffn`` formulated as a loop over experts, each running only its
    own tokens, gathered by index and scattered back: (output, aux loss,
    expert index (T,)). Reads the routing on the host; for checks only."""
    n_experts = params["router"].shape[1]
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    top, expert_idx = probs.max(dim=-1)
    gate = top.to(x.dtype)
    out = torch.zeros_like(x)
    for e in range(n_experts):
        rows = (expert_idx == e).nonzero().squeeze(1)
        h = F.gelu(x[rows] @ params["w1"][e], approximate="tanh")
        out[rows] = (h @ params["w2"][e]) * gate[rows, None]
    frac = torch.bincount(expert_idx, minlength=n_experts).float() / x.shape[0]
    aux = n_experts * (frac * probs.mean(dim=0)).sum()
    return out, aux, expert_idx


def make_moe_step(n_experts: int, d_model: int, d_ff: int, lr: float = 1e-2,
                  mesh=None):
    """Returns step(params, x, target) -> (new params, loss): one SGD step
    of the loss MSE(out, target) in float32 + 0.01 x aux, the update in
    float32 cast back to each param's dtype (the router stays float32).
    Params are ``init_moe_params``'s dict of these sizes.

    mesh: a ("data", "expert") ``parallel.mesh.Mesh``, the reference's
    ``make_moe_step(mesh, ...)``. Params are this rank's shards
    (``shard_moe_params``); x and target are the whole batch, of which
    each rank takes its rows along "data". The loss is the whole batch's,
    and the gradients are averaged over "data" before the update.
    Collectives a step: over "expert" (size > 1), 1 (the combine's sum; x
    takes no gradient, so f's backward never runs); over "data" (size >
    1), 5 (the routed fractions, the three gradient sums, the loss).
    """
    n_local = n_experts
    if mesh is not None:
        if mesh.axis_names != ("data", "expert"):
            raise ValueError(f"make_moe_step runs over ('data', 'expert') mesh axes, "
                             f"got {mesh.axis_names}")
        if n_experts % mesh.size("expert"):
            raise ValueError(f"{n_experts} experts do not split evenly over the "
                             f"'expert' axis of size {mesh.size('expert')}")
        n_local = n_experts // mesh.size("expert")
    shapes = {"router": (d_model, n_experts), "w1": (n_local, d_model, d_ff),
              "w2": (n_local, d_ff, d_model)}

    def loss_fn(params, x, target):
        out, aux = moe_ffn(params, x, mesh, "expert")
        return (out.float() - target.float()).square().mean() + 0.01 * aux

    def step(params, x, target):
        got = {key: tuple(value.shape) for key, value in params.items()}
        if got != shapes:
            raise ValueError(f"params of shapes {got}, the step was made for {shapes}")
        leaves = {key: value.detach().requires_grad_() for key, value in params.items()}
        if mesh is not None:
            x, target = shard_batch(x, mesh), shard_batch(target, mesh)
        loss = loss_fn(leaves, x, target)
        grads = {key: g.contiguous() for key, g in
                 zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}
        loss = mean_over_data([loss.detach().clone()], mesh)[0]
        mean_over_data(list(grads.values()), mesh)
        with torch.no_grad():
            new = {key: (value.float() - lr * grads[key].float()).to(value.dtype)
                   for key, value in params.items()}
        return new, loss.detach()

    return step
