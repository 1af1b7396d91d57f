"""Flash attention forward: a hand-written Hopper kernel and its plain version.

Counterpart of ``gpumounter_tpu/ops/flash_attention.py``. The kernel,
``csrc/flash_fwd.cu``, ports the Pallas ``_flash_kernel``: online-softmax
attention with causal masking, a sliding window joined with attention sinks,
softcap, grouped K/V heads and the decode offset for causal cross-length.
``attention_plain`` is the same function written out in PyTorch; it ports
the oracle ``_xla_attention``.

The path follows the tensors' device, never whether CUDA is present: a CUDA
tensor runs the kernel or raises ``ValueError`` naming what the kernel does
not take, and a CPU tensor runs ``attention_plain``. There is no fallback
from one to the other. The TPU dispatch tables and backends of the reference
(``_SWEEP_TABLE``, ``backend="auto"``) are v5e measurements and are not
ported.

Training: ``csrc/flash_bwd.cu`` ports the two Pallas backward kernels
(``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``) behind
``flash_attention_bwd_kernel``, with ``attention_bwd_plain`` as their plain
version (``_flash_backward`` written out in PyTorch). ``_FlashAttentionFn``
joins them to the forward kernel as the reference's two custom VJPs do:
``flash_attention_with_lse`` differentiates in both outputs, and the public
``flash_attention`` goes through it when grad is on.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from gpumounter_tpu_torch.ops import _build

NEG_INF = -1e30  # large-but-finite: -inf breaks the m == NEG_INF row fixups
LOG2E = 1.4426950408889634  # log2(e): the kernel's softmax runs in base 2

KERNEL_HEAD_DIMS = (32, 64, 128)  # one template instance each in flash_fwd.cu
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check_band_args(q, k, causal, window, sinks):
    """The argument rules shared by the kernel wrapper and the plain version
    (``flash_attention_pallas``'s checks)."""
    h, h_kv = q.shape[1], k.shape[1]
    l_q, l_k = q.shape[2], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({h_kv})")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if sinks and window is None:
        raise ValueError("sinks only make sense with a sliding window")
    if causal and l_q > l_k:
        raise ValueError(f"causal attention needs L_q <= L_k (queries "
                         f"are the last L_q key positions); got "
                         f"L_q={l_q} L_k={l_k}")


def _band_mask(l_q: int, l_k: int, window, sinks: int, device) -> torch.Tensor:
    """(L_q, L_k) bool: key j is attendable from query row i. The query sits
    at p = (L_k − L_q) + i on the key timeline and attends keys [p − window,
    p], joined with the sinks [0, sinks) when a window is set."""
    q_pos = (l_k - l_q) + torch.arange(l_q, device=device)[:, None]
    keys = torch.arange(l_k, device=device)[None, :]
    keep = keys <= q_pos
    if window is not None:
        in_band = keys >= q_pos - window
        if sinks:
            in_band = in_band | (keys < sinks)
        keep = keep & in_band
    return keep


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None, softcap: float | None = None,
                    sinks: int = 0, return_lse: bool = False):
    """Materialised-(L_q, L_k) attention, the kernel's plain version.

    q (B, H, L_q, D); k, v (B, H_kv, L_k, D) with H % H_kv == 0 (q head h
    reads kv head h // group). Scores and softmax are in float32 and the
    output is cast to q's dtype, as in ``_xla_attention``; unlike that
    oracle, the scores of bf16 inputs are not rounded to bf16 first. With
    return_lse, also returns the per-row log-sum-exp (B, H, L_q) float32 in
    natural units, NEG_INF for rows that see no key.
    """
    _check_band_args(q, k, causal, window, sinks)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:  # on the raw scaled scores, before the mask
        s = softcap * torch.tanh(s / softcap)
    if causal:
        keep = _band_mask(q.shape[2], k.shape[2], window, sinks, q.device)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    empty = s.amax(dim=-1) <= NEG_INF / 2
    return out, torch.where(empty, torch.full_like(lse, NEG_INF), lse)


def attention_bwd_plain(q, k, v, o, lse, do, dlse=None, *, causal=True,
                        scale=None, window=None, softcap=None, sinks=0):
    """(dq, dk, dv) of attention, the backward kernels' plain version.

    The reference's ``_flash_backward`` written out in PyTorch, in float32:
    p = exp(s − lse) from the saved natural-unit lse (0 where lse is
    NEG_INF), Δ = rowsum(do∘o) − dlse, ds = p∘(do·vᵀ − Δ) (times
    1 − (s_cap/cap)² with softcap), dq = ds·k·scale, dk = dsᵀ·q·scale,
    dv = pᵀ·do. dk and dv are summed over each GQA group in float32 and
    cast once; each gradient comes back in its input's dtype. Unlike the
    kernels, p and ds are not rounded to bf16 before their products.
    """
    _check_band_args(q, k, causal, window, sinks)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, l_q, d = q.shape
    h_kv, l_k = k.shape[1], k.shape[2]
    group = h // h_kv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    chain = None
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)  # s_cap, before the mask
        chain = 1.0 - (s / softcap).square()
    if causal:
        keep = _band_mask(l_q, l_k, window, sinks, q.device)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    lse_col = lse.float()[..., None]
    p = torch.where(lse_col <= NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - lse_col))
    delta = (dof * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    if chain is not None:
        ds = ds * chain
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, h_kv, group, l_k, d).sum(dim=2)
    dv = dv.reshape(b, h_kv, group, l_k, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_ptr, _int, _ll, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _library(device_index: int) -> ctypes.CDLL:
    """The forward kernels' library, its shared-memory limits raised on the
    device once, at load."""
    lib = _build.load("flash_fwd")
    lib.flash_fwd_init.restype = _int
    lib.flash_fwd_init.argtypes = []
    lib.flash_fwd.restype = _int
    lib.flash_fwd.argtypes = (
        [_ptr] * 5                 # q, k, v, o, lse
        + [_int] * 7               # dtype, B, H, H_kv, L_q, L_k, D
        + [_ll] * 9                # q, k, v strides: batch, head, row
        + [_int] * 3               # causal, window, sinks
        + [_float] * 2             # scale, softcap
        + [_ptr])                  # stream
    with torch.cuda.device(device_index):
        err = lib.flash_fwd_init()
    if err != 0:
        raise RuntimeError(f"flash_fwd_init failed: cudaError_t {err}")
    return lib


def _check_kernel_inputs(q, k, v):
    """Raise ValueError for what flash_fwd.cu does not take. The kernel reads
    strided (B, H, L, D) views (the probe's q/k/v are transposes of one
    projection, so no copy is made): only the head dim must be contiguous,
    and rows must start on 16-byte boundaries. bf16 inputs are read by TMA
    tensor maps, which also take no broadcast (zero-stride) dim."""
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_fwd takes bfloat16 or float32, got "
                         f"{q.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B, H, L_q, D) and k, v of one shape "
                         f"(B, H_kv, L_k, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, l_q, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch and head dim")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head dim {KERNEL_HEAD_DIMS}, got "
                         f"{d}")
    if l_q == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_fwd needs L_q, L_k >= 1, got shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if b * h > 65535:
        raise ValueError(f"flash_fwd launches one grid row per (b, h): "
                         f"B*H={b * h} exceeds 65535")
    if q.dtype == torch.bfloat16 and -(-l_q // 128) > 65535:
        raise ValueError(f"flash_fwd launches one grid column per 128 query "
                         f"rows: L_q={l_q} needs more than 65535")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in the head dim, got "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must start on 16-byte boundaries, "
                             f"got strides {t.stride()} at offset "
                             f"{t.data_ptr() % 16}")
        if t.dtype != torch.bfloat16:
            continue
        if any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)):
            raise ValueError(f"{name} is a broadcast view (strides "
                             f"{t.stride()}, shape {tuple(t.shape)}), which a "
                             f"TMA tensor map cannot read")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, scale: float | None = None,
                           window: int | None = None,
                           softcap: float | None = None, sinks: int = 0,
                           return_lse: bool = False):
    """(B, H, L_q, D) attention through ``csrc/flash_fwd.cu``; the wrapper
    of the port, counterpart of ``flash_attention_pallas``.

    CUDA tensors launch the kernel on the current stream (or raise
    ValueError); CPU tensors run ``attention_plain``. Any L works: the
    kernel masks keys past L_k and writes no row past L_q. Causal
    cross-length L_q <= L_k places the queries at the last L_q key
    positions (the decode convention). Each launch adds one to
    ``flash_attention_kernel.launches``.
    """
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, scale, window, softcap, sinks,
                               return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel runs on cuda or cpu "
                         f"tensors, got {q.device}")
    _check_band_args(q, k, causal, window, sinks)
    _check_kernel_inputs(q, k, v)
    b, h, l_q, d = q.shape
    h_kv, l_k = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = torch.empty((b, h, l_q, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, l_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library(q.device.index).flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if return_lse else None,
            _KERNEL_DTYPES[q.dtype], b, h, h_kv, l_q, l_k, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else window, sinks,
            scale, 0.0 if softcap is None else softcap, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err} "
                           f"for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    flash_attention_kernel.launches += 1
    return (o, lse) if return_lse else o


flash_attention_kernel.launches = 0


@functools.cache
def _bwd_library(device_index: int) -> ctypes.CDLL:
    """The backward kernels' library, its shared-memory limits raised on
    the device once, at load."""
    lib = _build.load("flash_bwd")
    lib.flash_bwd_init.restype = _int
    lib.flash_bwd_init.argtypes = []
    for name, n_out in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 2)):
        fn = getattr(lib, name)
        fn.restype = _int
        fn.argtypes = (
            [_ptr] * (6 + n_out)   # q, k, v, do, lse, delta; dq or dk, dv
            + [_int] * 7           # dtype, B, H, H_kv, L_q, L_k, D
            + [_ll] * 12           # q, k, v, do strides: batch, head, row
            + [_int] * 3           # causal, window, sinks
            + [_float] * 2         # scale, softcap
            + [_ptr])              # stream
    with torch.cuda.device(device_index):
        err = lib.flash_bwd_init()
    if err != 0:
        raise RuntimeError(f"flash_bwd_init failed: cudaError_t {err}")
    return lib


def _check_bwd_inputs(q, k, v, o, lse, do, dlse):
    """Raise ValueError for what flash_bwd.cu does not take, beyond
    ``_check_kernel_inputs``: o and do must match q, lse (and dlse) must be
    (B, H, L_q)."""
    _check_kernel_inputs(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q {tuple(q.shape)} "
                             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and t.shape != q.shape[:3]:
            raise ValueError(f"{name} must be (B, H, L_q) = "
                             f"{tuple(q.shape[:3])}, got {tuple(t.shape)}")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it strided, else a contiguous
    copy: autograd decides the layout of an incoming gradient, which may be
    a broadcast view (``w.expand_as(o)`` handed in as the gradient, or that
    of ``o.sum()``) that a TMA tensor map cannot read."""
    vec = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and not any(s % vec for s in t.stride()[:3])
            and not any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))):
        return t
    return t.contiguous()


def flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse=None, *,
                               causal: bool = True, scale: float | None = None,
                               window: int | None = None,
                               softcap: float | None = None, sinks: int = 0):
    """(dq, dk, dv) through ``csrc/flash_bwd.cu``; counterpart of the
    reference's ``_flash_backward``.

    q, o, do (B, H, L_q, D); k, v (B, H_kv, L_k, D); lse the forward's
    (B, H, L_q) float32 log-sum-exp; dlse an optional cotangent of lse,
    folded into Δ = rowsum(do∘o) − dlse, which is computed here in PyTorch
    before the launch, as the reference computes it outside its kernels.
    CUDA tensors launch the dq kernel, then the dk/dv kernel, on the current
    stream (or raise ValueError); CPU tensors run ``attention_bwd_plain``.
    Each launch adds one to ``flash_attention_bwd_kernel.dq_launches`` or
    ``.dkv_launches``. dk and dv are summed over each GQA group inside the
    kernel, in float32, and come back with H_kv heads.
    """
    tensors = [q, k, v, o, lse, do] + ([] if dlse is None else [dlse])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"backward inputs on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, dlse, causal=causal,
                                   scale=scale, window=window,
                                   softcap=softcap, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_kernel runs on cuda or cpu "
                         f"tensors, got {q.device}")
    _check_band_args(q, k, causal, window, sinks)
    _check_bwd_inputs(q, k, v, o, lse, do, dlse)
    b, h, l_q, d = q.shape
    h_kv, l_k = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    do = _kernel_layout(do)
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    lse = lse.float().contiguous()
    band = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                sinks=sinks)
    dq = torch.empty((b, h, l_q, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h_kv, l_k, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h_kv, l_k, d), dtype=v.dtype, device=q.device)
    _bwd_launch("dq", q, k, v, do, lse, delta, (dq,), **band)
    _bwd_launch("dkv", q, k, v, do, lse, delta, (dk, dv), **band)
    return dq, dk, dv


flash_attention_bwd_kernel.dq_launches = 0
flash_attention_bwd_kernel.dkv_launches = 0


def _bwd_launch(name, q, k, v, do, lse, delta, outs, *, causal, scale, window,
                softcap, sinks):
    """Launch ``flash_bwd_<name>`` (name "dq" or "dkv") on checked inputs:
    do in a layout the kernel reads, lse and delta float32 and contiguous,
    outs (dq, or dk and dv) contiguous. Adds one to that kernel's count."""
    b, h, l_q, d = q.shape
    h_kv, l_k = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        fn = getattr(_bwd_library(q.device.index), f"flash_bwd_{name}")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs),
                 _KERNEL_DTYPES[q.dtype], b, h, h_kv, l_q, l_k, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], int(causal),
                 -1 if window is None else window, sinks, scale,
                 0.0 if softcap is None else softcap,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{name} launch failed: cudaError_t "
                           f"{err} for q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    if name == "dq":
        flash_attention_bwd_kernel.dq_launches += 1
    else:
        flash_attention_bwd_kernel.dkv_launches += 1


class _FlashAttentionFn(torch.autograd.Function):
    """(o, lse) with a backward through the backward kernels: the
    counterpart of the reference's custom VJPs ``flash_attention_with_lse``
    and ``_flash_attention_trainable``. The forward is the forward kernel
    with lse, saved with q, k, v and o; the backward folds the lse
    cotangent into Δ. On CPU tensors both directions are the plain
    versions, so no graph is taken through ``attention_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, softcap, sinks):
        o, lse = flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                        window=window, softcap=softcap,
                                        sinks=sinks, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.band = dict(causal=causal, scale=scale, window=window,
                        softcap=softcap, sinks=sinks)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse,
                                                **ctx.band)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             scale: float | None = None,
                             window: int | None = None,
                             softcap: float | None = None, sinks: int = 0):
    """Differentiable (o, lse): o (B, H, L_q, D) in q's dtype and lse
    (B, H, L_q) float32, both carrying gradients (an lse cotangent folds
    into Δ, as in the reference). Causal cross-length follows the decode
    convention of ``flash_attention_kernel``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionFn.apply(q, k, v, causal, scale, window, softcap,
                                   sinks)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None, softcap: float | None = None,
                    sinks: int = 0) -> torch.Tensor:
    """Public entry, with the reference's argument checks.

    window (requires causal): each query attends keys [q − window, q], so
    window=W attends W+1 keys (Mistral/HF sliding_window=W is window=W−1
    here). softcap: cap·tanh(s/cap) on the raw scores. sinks (requires
    window): keep the first `sinks` keys attendable. Causal cross-length is
    refused here; decode callers use flash_attention_kernel directly. When
    grad is on and an input requires it, the call goes through
    ``_FlashAttentionFn`` (the forward kernel with lse, then the backward
    kernels); otherwise it is the forward kernel alone, without lse, as the
    reference's primal is.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if sinks and window is None:
        raise ValueError("sinks only make sense with a sliding window")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            f"causal flash_attention requires L_q == L_k (got "
            f"{q.shape[2]} vs {k.shape[2]}); for KV-cache decode use "
            f"flash_attention_kernel(..., return_lse=...) which follows "
            f"the decode convention")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, causal, scale, window,
                                       softcap, sinks)[0]
    return flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                  window=window, softcap=softcap, sinks=sinks)
