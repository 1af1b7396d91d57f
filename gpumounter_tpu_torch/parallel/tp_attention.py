"""Tensor-parallel attention: heads split over a mesh axis.

Counterpart of ``gpumounter_tpu/parallel/tp_attention.py``. Attention is
parallel over heads, so no collective is needed: each rank runs the port's
``flash_attention`` (the hand-written kernel on a CUDA tensor) on its own
head slice. Where the reference's shard_map hands each device its slice of
one global array, here each rank holds the whole (B, H, L, D) input and
keeps its own heads, and the output is this rank's slice.

GQA composes when the kv heads divide the axis too: rank r then holds
q heads [r·H/n, (r+1)·H/n) and kv heads [r·H_kv/n, (r+1)·H_kv/n), which
are whole groups, so the kernel's group mapping works on the slice
unchanged.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.ops.flash_attention import flash_attention


def shard_heads(x: torch.Tensor, mesh, head_axis: str = "model") -> torch.Tensor:
    """This rank's heads of a (B, H, L, D) tensor, H split evenly over the
    mesh axis (a view)."""
    n = mesh.size(head_axis)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} heads do not split evenly over the "
                         f"{head_axis!r} axis of size {n}")
    h = x.shape[1] // n
    r = mesh.coord(head_axis)
    return x[:, r * h:(r + 1) * h]


def tp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh, *, head_axis: str = "model", causal: bool = True,
                       scale: float | None = None, window: int | None = None,
                       softcap: float | None = None) -> torch.Tensor:
    """(B, H/n, L, D): this rank's heads of the attention of q (B, H, L, D)
    over k, v (B, H_kv, L, D), for n the size of `head_axis`. Both H and
    H_kv must divide n, so that every rank holds whole GQA groups."""
    n_shards = mesh.size(head_axis)
    h, h_kv = q.shape[1], k.shape[1]
    if h % n_shards or h_kv % n_shards:
        raise ValueError(
            f"heads must divide the {head_axis!r} axis evenly: "
            f"H={h}, H_kv={h_kv}, axis size {n_shards}")
    return flash_attention(*(shard_heads(t, mesh, head_axis) for t in (q, k, v)),
                           causal=causal, scale=scale, window=window,
                           softcap=softcap)
