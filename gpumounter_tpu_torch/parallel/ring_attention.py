"""Ring attention: the sequence split over a mesh axis, K/V chunks rotating.

Counterpart of ``gpumounter_tpu/parallel/ring_attention.py``, its flash body
(``_ring_flash_local``). Each rank holds one chunk of the sequence of q, k
and v (B, H, L/n, D); the K/V chunks travel around the ring one step at a
time (``collectives.ring_shift``, k and v in one node), and each rank
attends its queries to every chunk it holds in turn through
``flash_attention_with_lse``: the forward kernel with lse on a CUDA tensor,
and in the backward the dq and dk/dv kernels with the lse cotangent folded
into Δ (the chunks merge through their lse, so that cotangent is not zero);
their plain versions on a CPU tensor. The partial results merge in float32
by their log-sum-exps (``_combine_chunks``), so no rank holds more than a
chunk's K/V and its own output.

Causal chunk classification is plain Python control flow: the chunk from
coordinate src is skipped when src > c (every key is in the future),
attended causally when src == c (the diagonal) and whole when src < c.
The last step's rotation, whose result the reference discards, is left out:
n − 1 shifts a call.

Left out of the reference on purpose: ``impl``, ``block_q``, ``block_k`` and
the einsum body ``_ring_attention_local`` (the port has no dispatch between
bodies, as it has no ``attn_backend``), and ``data_axis``: a rank holds its
own rows already.
"""

from __future__ import annotations

import math

import torch

from gpumounter_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_with_lse
from gpumounter_tpu_torch.parallel.collectives import ring_shift, tie


def _combine_chunks(o_prev, lse_prev, o_chunk, lse_chunk):
    """Merge two normalized partial-attention results via their
    log-sum-exps: o = Σᵢ oᵢ·exp(lseᵢ − logaddexp(lse₁, lse₂)). A row that
    saw no key has lse NEG_INF, the kernel's sentinel, and weighs 0."""
    lse_new = torch.logaddexp(lse_prev, lse_chunk)
    w_prev = torch.exp(lse_prev - lse_new)[..., None]
    w_chunk = torch.exp(lse_chunk - lse_new)[..., None]
    return o_prev * w_prev + o_chunk * w_chunk, lse_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   seq_axis: str = "seq", causal: bool = True,
                   scale: float | None = None,
                   softcap: float | None = None) -> torch.Tensor:
    """This rank's chunk (B, H, L/n, D) of the attention of the sequence
    split over `seq_axis` (n ranks): q (B, H, L/n, D) and k, v (B, H_kv,
    L/n, D) are this rank's chunks, the chunk at coordinate c holding
    positions [c·L/n, (c+1)·L/n). GQA rotates the compact H_kv heads.
    softcap caps every chunk's scores (capping is per score, so the lse
    merge is exact). Every rank of the axis must call it together. The
    output is in q's dtype; differentiable in q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads ({q.shape[1]}) must be a multiple of "
                         f"kv heads ({k.shape[1]})")
    n, c = mesh.size(seq_axis), mesh.coord(seq_axis)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    # The kernel's masked-row sentinel exactly: the merge weighs a row that
    # has seen no key yet exp(NEG_INF − x) = 0 only if both use one value.
    lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
    kv = (k, v)
    for s in range(n):
        src = (c - s) % n  # the coordinate the K/V chunk held now came from
        if not causal or src <= c:
            o_chunk, lse_chunk = flash_attention_with_lse(
                q, *kv, causal=causal and src == c, scale=scale, softcap=softcap)
            o, lse = _combine_chunks(o, lse, o_chunk.float(), lse_chunk)
        if s < n - 1:
            kv = ring_shift(kv, mesh, seq_axis)
    if n > 1:
        o = tie(o, *kv)  # the last shift's backward runs on every rank
    return o.to(q.dtype)


def reference_attention(q, k, v, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """One-process O(L²) attention over whole sequences; the correctness
    oracle. q, k, v (B, H, L, D) with equal heads; float32 scores and
    softmax, the output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        l_q, l_k = q.shape[2], k.shape[2]
        keep = torch.arange(l_k, device=q.device)[None, :] <= torch.arange(
            l_q, device=q.device)[:, None]
        scores = scores.masked_fill(~keep, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
