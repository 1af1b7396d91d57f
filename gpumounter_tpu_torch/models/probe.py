"""The probe transformer's forward pass in PyTorch.

Counterpart of ``gpumounter_tpu/models/probe.py``, forward path only: a
small decoder-only transformer whose every block's attention goes through
``ops.flash_attention`` (the hand-written kernel for CUDA tensors, its plain
version for CPU tensors). Parameters are a plain dict in the reference's
layout — ``x @ W`` with W of shape (in, out) — so weights carry across
without transposes (``weights.params_from_jax``).

Not ported yet: ``generate()`` and its KV cache (the serving slice), the
MoE FFN, sequence-parallel attention, and the training loss and step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.ops.flash_attention import flash_attention


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 128
    dtype: torch.dtype = torch.bfloat16
    # Attention dialect (defaults reproduce plain MHA): fewer K/V heads
    # (GQA/MQA), a sliding window over the last `window` positions, and
    # rotary position embeddings (rope=True replaces the learned table).
    n_kv_heads: int | None = None
    window: int | None = None
    rope: bool = False
    rope_base: float = 10000.0
    n_experts: int | None = None
    moe_aux_weight: float = 0.01
    attn_parallel: str = "heads"

    def __post_init__(self):
        if self.n_experts is not None and self.n_experts < 2:
            raise ValueError(f"n_experts must be >= 2, got "
                             f"{self.n_experts}")
        if self.attn_parallel not in ("heads", "seq"):
            raise ValueError(f"attn_parallel must be heads|seq, got "
                             f"{self.attn_parallel!r}")
        if self.attn_parallel == "seq" and self.window is not None:
            raise ValueError(
                "attn_parallel='seq' does not support sliding windows "
                "(ring attention has no band skipping across chunks "
                "yet); use the heads layout for windowed configs")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model ({self.d_model}) must divide by "
                             f"n_heads ({self.n_heads})")
        if self.n_kv_heads is not None and (
                self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads):
            raise ValueError(f"n_kv_heads ({self.n_kv_heads}) must be "
                             f">= 1 and divide n_heads ({self.n_heads})")
        if self.window is not None and self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.rope and self.d_head % 2:
            raise ValueError(f"rope needs an even d_head, got "
                             f"{self.d_head}")
        if self.rope_base <= 0:
            raise ValueError(f"rope_base must be > 0, got "
                             f"{self.rope_base}")
        if self.n_experts is not None:
            raise NotImplementedError(
                "the MoE FFN is not ported yet (ROADMAP.md, modules to "
                "port: models/probe.py with parallel/moe.py)")
        if self.attn_parallel == "seq":
            raise NotImplementedError(
                "attn_parallel='seq' (ring attention) is not ported yet "
                "(ROADMAP.md, modules to port: parallel/ across several "
                "GPUs)")

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights N(0, 0.02²) in cfg.dtype, drawn from `generator` on
    its own device and moved to `device`. torch's generator gives other
    numbers than jax.random for the same seed; tests carry JAX weights
    across with ``weights.params_from_jax`` instead."""
    device = resolve_device(device)

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * 0.02).to(device=device, dtype=cfg.dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=cfg.dtype)

    params = {"embed": dense(cfg.vocab, cfg.d_model), "blocks": []}
    if not cfg.rope:
        params["pos"] = dense(cfg.max_len, cfg.d_model)
    kv_dim = cfg.kv_heads * cfg.d_head
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "wqkv": dense(cfg.d_model, cfg.d_model + 2 * kv_dim),
            "wo": dense(cfg.d_model, cfg.d_model),
            "ln1": ones(cfg.d_model),
            "ln2": ones(cfg.d_model),
            "w1": dense(cfg.d_model, cfg.d_ff),
            "w2": dense(cfg.d_ff, cfg.d_model),
        })
    return params


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # Variance in f32; rsqrt cast to x's dtype before the multiply.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * g


def _qkv_heads(x, p, cfg):
    """rmsnorm + QKV projection split into q (b, n_heads, t, d_head) and
    k, v (b, kv_heads, t, d_head). These are strided views of one
    projection; the attention kernel reads them as they are."""
    b, t, _ = x.shape
    qkv = _rmsnorm(x, p["ln1"]) @ p["wqkv"]
    kv_dim = cfg.kv_heads * cfg.d_head
    q, k, v = qkv.split([cfg.d_model, kv_dim, kv_dim], dim=-1)

    def heads(a, n):
        return a.reshape(b, t, n, cfg.d_head).transpose(1, 2)

    return heads(q, cfg.n_heads), heads(k, cfg.kv_heads), heads(v, cfg.kv_heads)


def _rope_rotate(x, positions, cfg):
    """Rotary embedding of (b, h, t, d_head) at int `positions` (t,); the
    angles are computed in f32 from the positions, the halves rotated."""
    half = cfg.d_head // 2
    inv_freq = 1.0 / (cfg.rope_base ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * inv_freq[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)           # (t, half)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _maybe_rope(q, k, cfg, positions):
    """Rotate q and k (not v) when the config asks for rope."""
    if not cfg.rope:
        return q, k
    return _rope_rotate(q, positions, cfg), _rope_rotate(k, positions, cfg)


def _finish_block(x, attn_heads, p):
    """Output projection, residual, dense FFN (tanh GELU, as jax.nn.gelu's
    default)."""
    b, _, t, _ = attn_heads.shape
    merged = attn_heads.transpose(1, 2).reshape(b, t, -1)
    x = x + merged @ p["wo"]
    h = _rmsnorm(x, p["ln2"])
    return x + F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]


def _block(x, p, cfg, attention):
    q, k, v = _qkv_heads(x, p, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    q, k = _maybe_rope(q, k, cfg, positions)
    return _finish_block(x, attention(q, k, v, causal=True,
                                      window=cfg.window), p)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attention=flash_attention) -> torch.Tensor:
    """float32 logits (batch, seq, vocab) for integer tokens (batch, seq).

    attention: called as ``attention(q, k, v, causal=True, window=...)``;
    the default is the port's flash_attention. Passing ``attention_plain``
    gives the same forward with the kernel's plain version, which is how
    the kernel's run is checked on the card.
    """
    b, t = tokens.shape
    if t > cfg.max_len:
        raise ValueError(f"sequence length {t} exceeds max_len "
                         f"{cfg.max_len}")
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos"][:t]
    for blk in params["blocks"]:
        x = _block(x, blk, cfg, attention)
    return (x @ params["embed"].T).float()


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits (B, T, V) against
    tokens (B, T), shifted by one."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())
    return nll.mean()
