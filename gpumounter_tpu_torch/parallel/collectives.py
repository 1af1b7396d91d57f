"""The collectives of the sharded steps, counted on the mesh.

GSPMD derives the reference's collectives from its shardings; the port
states them. Megatron's two conjugate operators carry the tensor-parallel
split of a block:

- **f** (``copy_to``): identity in the forward, all-reduce of the gradient
  in the backward. It stands at each column-parallel input (before
  ``wqkv``, before ``w1`` or the experts), whose replicated activation feeds
  a different shard of the product on every rank.
- **g** (``reduce_from``): all-reduce in the forward, identity in the
  backward. It stands after each row-parallel product (``wo``, ``w2`` or
  the expert combine), whose partial sums it adds.

``torch.distributed.nn.functional.all_reduce`` is not g: its backward
all-reduces too, which would multiply every gradient upstream by the axis
size. An axis of size 1 runs no collective and counts none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum x over `axis` in place (x must be contiguous); returns x."""
    if mesh.size(axis) > 1:
        dist.all_reduce(x, group=mesh.groups[axis])
        mesh.calls[axis] += 1
        mesh.bytes[axis] += x.nbytes
    return x


def all_gather(x: torch.Tensor, mesh, axis: str) -> list[torch.Tensor]:
    """Every rank's x along `axis`, in axis order (x itself when the axis
    has size 1)."""
    if mesh.size(axis) == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(out, x, group=mesh.groups[axis])
    mesh.calls[axis] += 1
    mesh.bytes[axis] += x.nbytes * mesh.size(axis)
    return out


def mean_over_data(tensors: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Each tensor (contiguous) replaced in place by its mean over the
    mesh's data axis (the first): one all-reduce each. No-op without a
    mesh."""
    if mesh is not None:
        data = mesh.axis_names[0]
        for t in tensors:
            all_reduce(t, mesh, data)
            if mesh.size(data) > 1:
                t.div_(mesh.size(data))
    return tensors


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """f: x as it is; its gradient summed over `axis`."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """g: x summed over `axis`; its gradient passed through."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)
