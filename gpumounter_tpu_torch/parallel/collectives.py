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

The ring and the pipeline move tensors one step around an axis with
``ring_shift``, the counterpart of the reference's ``jax.lax.ppermute``
with the permutation c -> (c + 1) mod n; its backward is the transpose,
the gradients sent one step back.
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


def sum_over(tensors: list[torch.Tensor], mesh, axes) -> list[torch.Tensor]:
    """Each tensor (contiguous) replaced in place by its sum over every
    axis of `axes`: one all-reduce a tensor an axis of size > 1."""
    for axis in axes:
        for t in tensors:
            all_reduce(t, mesh, axis)
    return tensors


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
    """f: x as it is; its gradient summed over `axis` (none without a mesh
    or an axis)."""
    if mesh is None or axis is None or mesh.size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """g: x summed over `axis` (x itself without a mesh or an axis); its
    gradient passed through."""
    if mesh is None or axis is None or mesh.size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def _exchange(send: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """Send `send` to the rank `step` places ahead on `axis` and return
    what the rank `step` places behind sent, contiguous, of the same shape
    and dtype, tagged with the axis's message count so that ranks that
    disagree on the order wait and time out rather than pair the wrong
    messages. gloo's point-to-point calls read a CUDA tensor's device
    pointer as host memory and fail ("Bad address", on an H100 with torch
    2.11), so a CUDA tensor over gloo goes by way of host buffers, as
    gloo's all-reduce does inside; other backends send it as it is."""
    n, c = mesh.size(axis), mesh.coord(axis)
    group = mesh.groups[axis]
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    payload = send.contiguous().cpu() if staged else send.contiguous()
    got = torch.empty_like(payload)
    tag = mesh.sent[axis]
    mesh.sent[axis] += 1
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, payload, mesh.rank_at(axis, (c + step) % n), group, tag),
        dist.P2POp(dist.irecv, got, mesh.rank_at(axis, (c - step) % n), group, tag)])
    for work in works:
        work.wait()
    return got.to(send.device) if staged else got


def _shift(tensors, mesh, axis: str, step: int) -> tuple:
    """Every tensor moved `step` places around `axis`; one call counted,
    with the bytes sent."""
    mesh.calls[axis] += 1
    mesh.bytes[axis] += sum(t.nbytes for t in tensors)
    return tuple(_exchange(t, mesh, axis, step) for t in tensors)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, n_tensors, *args):
        ctx.mesh, ctx.axis, ctx.n_anchors = mesh, axis, len(args) - n_tensors
        return _shift(args[:n_tensors], mesh, axis, 1)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *_shift(grads, ctx.mesh, ctx.axis, -1),
                *(None,) * ctx.n_anchors)


def ring_shift(tensors, mesh, axis: str, anchors=()) -> tuple:
    """The tensors sent one step around `axis` (coordinate c to (c + 1) mod
    n) and those of c − 1 received in their place; in the backward the
    gradients go one step back (the transpose). Every rank of the axis must
    call it together, tensors of the same shapes and dtypes.

    All the tensors move in one autograd node, so that a chain of shifts
    (each one's output feeding the next) runs its backward sends in the
    same order on every rank. A rank whose shifted tensors take no part in
    its loss would leave its node out of the backward, and its neighbours
    would wait for it: `anchors` are tensors passed through the node
    untouched (they get no gradient from it) that make its output need a
    gradient on every rank alike, and a caller ties the chain's last output
    into its result with ``tie``. Each call counts once on the axis, each
    direction, with the bytes it sends. An axis of size 1 moves nothing."""
    tensors = tuple(tensors)
    if mesh.size(axis) == 1:
        return tensors
    return _RingShift.apply(mesh, axis, len(tensors), *tensors, *anchors)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.n_others = len(others)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return (dx, *(None,) * ctx.n_others)


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """x as it is; `others` take a zero gradient from it. A backward from x
    then reaches the nodes that made `others` (autograd runs them on
    zeros), which a ring or a pipeline needs of its last shift on every
    rank (``ring_shift``)."""
    if not torch.is_grad_enabled():
        return x
    return _Tie.apply(x, *others)
