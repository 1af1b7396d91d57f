"""Pipeline parallelism: microbatch schedules over a mesh axis.

Counterpart of ``gpumounter_tpu/parallel/pipeline.py``. Each rank of the
"pipe" axis holds only its own stage parameters; activations move one stage
a tick with ``collectives.ring_shift`` (the reference's ``ppermute`` inside
its ``fori_loop``), in a Python loop over the ticks of a fixed schedule.

Two schedules behind one entry point (``n_virtual``):

* **GPipe** (``n_virtual=1``): P ranks = P stages; microbatch m runs on
  stage p at tick m + p. Bubble: P - 1 of M + P - 1 ticks.
* **Interleaved / circular** (``n_virtual=v > 1``): each rank owns v
  non-contiguous stage chunks (logical stage s = k·P + d lives on rank d,
  chunk k). Rank d runs chunk k of microbatch m at tick

      t = d + (m mod P) + P·(v·⌊m/P⌋ + k)

  which assigns every rank at most one (chunk, microbatch) a tick and keeps
  the data motion one forward ring shift a tick: the tick that produces
  stage s is always the one before the tick that consumes it in stage
  s + 1 (the chunk boundary wraps rank P − 1 to rank 0 on the same ring
  edge). Bubble: still P − 1 ticks, of M·v + P − 1.

The schedule is the same on every rank: each runs the shift every tick,
sending zeros on a tick where it is idle, and skips the stage's compute on
those ticks (the reference computes it and zeroes the result). The last
tick's shift, whose result nobody reads, is left out. Both schedules
differentiate through autograd: the shifts' backward sends the cotangents
one stage back, in the mirrored order on every rank.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.parallel.collectives import copy_to, reduce_from, ring_shift, tie
from gpumounter_tpu_torch.parallel.mesh import shard_leaf
from gpumounter_tpu_torch.parallel.train_step import tree_leaves, tree_map


def schedule_info(n_micro: int, n_stages: int, n_virtual: int = 1) -> dict:
    """Bubble accounting for a (M, P, v) pipeline schedule.

    ticks: total schedule length; busy device-ticks are M·v per device,
    so bubble_fraction = 1 - M·v / ticks = (P - 1) / ticks.
    """
    ticks = n_micro * n_virtual + n_stages - 1
    return {
        "ticks": ticks,
        "bubble_ticks": n_stages - 1,
        "bubble_fraction": (n_stages - 1) / ticks,
    }


def _tick_work(t: int, stage: int, n_stages: int, n_virtual: int, n_micro: int):
    """(microbatch m, chunk k) that `stage` runs at tick t, or None on an
    idle tick: u = t − stage split by the mixed radix u = r + P·(j·v + k),
    m = j·P + r. For v = 1 this is m = u, k = 0, the GPipe schedule."""
    u = t - stage
    if u < 0:
        return None
    q, r = divmod(u, n_stages)
    j, k = divmod(q, n_virtual)
    m = j * n_stages + r
    return (m, k) if m < n_micro else None


def pipeline_apply(stage_params, x: torch.Tensor, mesh, stage_fn, *, n_micro: int,
                   pipe_axis: str = "pipe", n_virtual: int = 1) -> torch.Tensor:
    """Run x (B, *rest) through the pipeline with M microbatches split
    along the batch axis; every rank returns the whole output.

    stage_params: this rank's block of the stage-stacked params
    (``shard_stage_params``), each leaf (1, ...) for GPipe (n_virtual=1)
    or (1, v, ...) interleaved (n_virtual=v), the leading 1 the pipe axis.
    stage_fn(chunk_params, x_mb) -> y_mb (same shape and dtype) where
    chunk_params has the leading axes stripped. x is the whole batch on
    every rank. B must divide by n_micro; the interleaved schedule also
    needs n_micro % P == 0. x goes in through f (``copy_to``), so the input
    gradient, which only stage 0 computes, reaches every rank; the output
    comes out of g (``reduce_from``: the last stage's outputs summed with
    the other ranks' zeros), so a loss computed from it on every rank is
    the whole loss and its gradient is counted once. Every rank of the
    axis must call it together.
    """
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    n_stages = mesh.size(pipe_axis)
    if n_virtual < 1:
        raise ValueError(f"n_virtual must be >= 1, got {n_virtual}")
    if n_virtual > 1 and n_micro % n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) divisible "
            f"by the stage count ({n_stages})")
    if n_virtual == 1:
        # Lift (1, ...) leaves to the unified (1, v=1, ...) layout.
        stage_params = tree_map(lambda a: a[:, None], stage_params)
    for leaf in tree_leaves(stage_params):
        # The reference reads shape[1] of a leaf with fewer than 2 dims and
        # raises IndexError; the port names the shape the schedule needs.
        if leaf.dim() < 2 or leaf.shape[0] != 1 or leaf.shape[1] != n_virtual:
            got = (leaf.shape[0] * n_stages, *leaf.shape[1:2])
            raise ValueError(
                f"stage param leaf has leading shape {got}, "
                f"expected ({n_stages}, {n_virtual})")
    chunks = [tree_map(lambda a, k=k: a[0, k], stage_params) for k in range(n_virtual)]
    x_micro = copy_to(x, mesh, pipe_axis).reshape(n_micro, b // n_micro, *x.shape[1:])
    stage = mesh.coord(pipe_axis)
    # Passed through every shift: they make it need a gradient on every
    # rank alike, whether or not this rank's tick did work (ring_shift).
    anchors = (x_micro, *tree_leaves(stage_params))
    outs = [torch.zeros(x_micro.shape[1:], dtype=torch.float32, device=x.device)
            for _ in range(n_micro)]
    recv = torch.zeros(x_micro.shape[1:], dtype=x.dtype, device=x.device)
    n_ticks = schedule_info(n_micro, n_stages, n_virtual)["ticks"]
    for t in range(n_ticks):
        work = _tick_work(t, stage, n_stages, n_virtual, n_micro)
        if work is None:
            y = torch.zeros_like(recv)
        else:
            m, k = work
            # The first logical stage reads its own input; all others use
            # the received activation.
            y = stage_fn(chunks[k], x_micro[m] if stage == 0 and k == 0 else recv)
            if stage == n_stages - 1 and k == n_virtual - 1:
                outs[m] = y.float()  # the last logical stage's finished microbatch
        if t < n_ticks - 1:
            # The previous tick's received tensor rides along, so the shifts
            # form one chain whose backward runs in the same order everywhere.
            recv = ring_shift((y,), mesh, pipe_axis, anchors=(recv, *anchors))[0]
    out = tie(torch.stack(outs), recv)
    return reduce_from(out, mesh, pipe_axis).to(x.dtype).reshape(x.shape)


def shard_stage_params(stage_params, mesh, pipe_axis: str = "pipe"):
    """This rank's block of stage-stacked params, each leaf (P, ...) cut
    along its leading pipe axis and kept (1, ...), on the mesh's device."""
    return tree_map(lambda leaf: shard_leaf(leaf, (pipe_axis,) + (None,) * (leaf.dim() - 1),
                                            mesh), stage_params)
