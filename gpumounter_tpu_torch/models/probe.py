"""The probe transformer's forward pass, training loss and serving path in
PyTorch.

Counterpart of ``gpumounter_tpu/models/probe.py``: a small decoder-only
transformer whose every block's attention goes through
``ops.flash_attention`` (forward and prefill) or ``ops.flash_decode`` (one
token against the KV cache) — the hand-written kernels for CUDA tensors,
their plain versions for CPU tensors. Parameters are a plain dict in the
reference's layout — ``x @ W`` with W of shape (in, out) — so weights carry
across without transposes (``weights.params_from_jax``).

Serving: ``prefill`` fills a fixed-shape cache per layer, ``decode_step``
adds one token at a cache length held on the device (no host sync, so a
step can be captured as one CUDA graph), and ``generate`` loops them. The
port updates the caches, the token, the length and the output in place
where the reference threads new arrays through its scan.

Compiled once per key: the reference jits ``forward`` and ``generate``.
On CUDA tensors the port runs each as CUDA graphs cached by
``ops.graphs`` (captured on the first call for a key, replayed on every
later one): ``forward`` as one graph per (cfg, token layout, parameter
storage), ``generate`` as a prefill graph and a decode-step graph per (cfg,
prompt layout, n_new, greedy or sampled, parameter storage), the step
replayed once per new token. ``capture=False`` runs the eager bodies, which
CPU tensors always run.

Training: ``loss_fn`` is the mean next-token NLL of ``forward``, which is
differentiable end to end; under grad every block's attention runs the
forward kernel with lse and the two backward kernels
(``ops.flash_attention._FlashAttentionFn``). The single-GPU train steps are
in ``parallel/train_step.py``.

MoE: with ``n_experts`` set, every block's FFN is the Switch-style top-1
routed FFN of ``parallel/moe.py`` (a float32 router and stacked expert
weights per block), and ``loss_fn`` adds ``moe_aux_weight`` x its
load-balancing loss averaged over the layers. The serving path drops that
loss, as the reference does.

dp x tp: ``forward`` and ``loss_fn`` take a ``parallel.mesh.Mesh`` whose
axes are (data, model), and this rank's shards of the params
(``parallel.train_step.shard_params``) and of the batch. Each block then
runs on its local heads and its local d_ff columns or experts: Megatron's
f (``parallel.collectives.copy_to``) before ``wqkv`` and before ``w1`` or
the experts, g (``reduce_from``) after ``wo`` and after ``w2`` or the
expert combine. Attention needs no collective; every rank runs the
kernels on its own H/tp q heads and H_kv/tp kv heads. The embedding, the
norms, the router and the logits are computed whole on every rank.

dp x sp (``attn_parallel="seq"``): the mesh's axes are (data, seq), the
params are whole on every rank, and a rank holds its rows of the batch and
its chunk of their positions. Nothing splits heads and nothing runs f or g:
the blocks are token-local but for attention, which is
``parallel.ring_attention`` over the seq axis, and RoPE and the learned
positions take the chunk's global positions. The MoE's routed fractions
are averaged over both axes (``parallel.moe.moe_ffn``). ``loss_fn`` takes
the rank's rows whole, since the last position of a chunk predicts the
first token of the next, and returns the rank's share of the loss: its
positions' NLL summed and divided by the whole batch's count B·(L − 1),
plus its share of the aux loss, so that the shares sum to the loss over
the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.ops import graphs
from gpumounter_tpu_torch.ops.flash_attention import flash_attention
from gpumounter_tpu_torch.ops.flash_decode import flash_decode
from gpumounter_tpu_torch.parallel.collectives import copy_to, reduce_from
from gpumounter_tpu_torch.parallel.moe import init_moe_params, moe_ffn
from gpumounter_tpu_torch.parallel.ring_attention import ring_attention


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
        block = {
            "wqkv": dense(cfg.d_model, cfg.d_model + 2 * kv_dim),
            "wo": dense(cfg.d_model, cfg.d_model),
            "ln1": ones(cfg.d_model),
            "ln2": ones(cfg.d_model),
        }
        if cfg.n_experts is None:
            block["w1"] = dense(cfg.d_model, cfg.d_ff)
            block["w2"] = dense(cfg.d_ff, cfg.d_model)
        else:
            block.update(init_moe_params(generator, cfg.n_experts, cfg.d_model,
                                         cfg.d_ff, cfg.dtype, device))
        params["blocks"].append(block)
    return params


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # Variance in f32; rsqrt cast to x's dtype before the multiply.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * g


def _tp_mesh(cfg, mesh):
    """The mesh whose second axis splits heads and the FFN: `mesh` in the
    heads layout, None in the seq layout (or without a mesh)."""
    return mesh if cfg.attn_parallel == "heads" else None


def _model_axis(mesh):
    return None if mesh is None else mesh.axis_names[1]


def _seq_chunk(mesh):
    """(size, this rank's coordinate) of the seq layout's sequence axis."""
    axis = mesh.axis_names[1]
    return mesh.size(axis), mesh.coord(axis)


def check_seq_split(batch: tuple, mesh) -> None:
    """Raise the reference's ValueError unless a (B, L) batch splits evenly
    over the seq layout's (data, seq) mesh."""
    data_ax, seq_ax = mesh.axis_names
    dp, sp = mesh.size(data_ax), mesh.size(seq_ax)
    if batch[0] % dp or batch[1] % sp:
        raise ValueError(
            f"attn_parallel='seq' needs batch/sequence to split "
            f"evenly: B={batch[0]} over {data_ax}={dp}, "
            f"L={batch[1]} over {seq_ax}={sp}")


def local_heads(cfg, mesh=None) -> tuple[int, int]:
    """(q heads, kv heads) of one rank: the config's, split over the mesh's
    model axis in the heads layout. Raises ValueError where they do not
    split evenly."""
    mesh = _tp_mesh(cfg, mesh)
    if mesh is None:
        return cfg.n_heads, cfg.kv_heads
    axis = _model_axis(mesh)
    tp = mesh.size(axis)
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(f"heads must divide the {axis!r} axis evenly: "
                         f"H={cfg.n_heads}, H_kv={cfg.kv_heads}, axis size {tp}")
    return cfg.n_heads // tp, cfg.kv_heads // tp


def _qkv_heads(x, p, cfg, mesh=None):
    """rmsnorm + QKV projection split into q (b, n_heads, t, d_head) and
    k, v (b, kv_heads, t, d_head), the head counts this rank's under a mesh
    (its wqkv holds its q, k and v heads' columns). These are strided views
    of one projection; the attention kernel reads them as they are."""
    b, t, _ = x.shape
    n_q, n_kv = local_heads(cfg, mesh)
    mesh = _tp_mesh(cfg, mesh)
    h = copy_to(_rmsnorm(x, p["ln1"]), mesh, _model_axis(mesh))
    q, k, v = (h @ p["wqkv"]).split(
        [n_q * cfg.d_head, n_kv * cfg.d_head, n_kv * cfg.d_head], dim=-1)

    def heads(a, n):
        return a.reshape(b, t, n, cfg.d_head).transpose(1, 2)

    return heads(q, n_q), heads(k, n_kv), heads(v, n_kv)


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


def _finish_block(x, p, mesh=None, layout="heads"):
    """rmsnorm, FFN and residual: (x, aux). The FFN is the MoE when the
    block carries a router (aux its load-balancing loss), else the dense
    FFN with tanh GELU, as jax.nn.gelu's default (aux 0.0). Under a mesh in
    the heads layout the FFN runs on this rank's d_ff columns or experts
    and is summed over the model axis; in the seq layout it runs whole on
    this rank's tokens."""
    h = _rmsnorm(x, p["ln2"])
    axis = _model_axis(mesh) if layout == "heads" else None
    if "router" in p:
        b, t, d = h.shape
        out, aux = moe_ffn(p, h.reshape(b * t, d), mesh, axis)
        return x + out.reshape(b, t, d), aux
    hidden = F.gelu(copy_to(h, mesh, axis) @ p["w1"], approximate="tanh")
    return x + reduce_from(hidden @ p["w2"], mesh, axis), 0.0


def _project(x, attn_heads, p, mesh=None):
    """x plus the output projection of the attention heads (b, h, t, d),
    summed over the model axis under a mesh."""
    b, _, t, _ = attn_heads.shape
    out = attn_heads.transpose(1, 2).reshape(b, t, -1) @ p["wo"]
    return x + reduce_from(out, mesh, _model_axis(mesh))


def _attend(x, p, cfg, attention, mesh=None):
    """The attention half of a block over the whole sequence: (x plus its
    attention's projection, post-RoPE k and v (b, kv_heads, t, d_head),
    which is what the cache stores). In the seq layout x is this rank's
    chunk of the sequence, at its global positions, and attention is the
    ring over the seq axis."""
    q, k, v = _qkv_heads(x, p, cfg, mesh)
    t = x.shape[1]
    seq = mesh is not None and cfg.attn_parallel == "seq"
    start = _seq_chunk(mesh)[1] * t if seq else 0
    q, k = _maybe_rope(q, k, cfg, torch.arange(start, start + t, device=x.device))
    if seq:
        out = ring_attention(q, k, v, mesh, seq_axis=mesh.axis_names[1], causal=True)
    else:
        out = attention(q, k, v, causal=True, window=cfg.window)
    return _project(x, out, p, _tp_mesh(cfg, mesh)), k, v


def _block(x, p, cfg, attention, return_kv=False, mesh=None):
    """One block over the whole sequence: (x, aux), with return_kv also its
    k and v."""
    x, k, v = _attend(x, p, cfg, attention, mesh)
    x, aux = _finish_block(x, p, mesh, cfg.attn_parallel)
    return (x, aux, k, v) if return_kv else (x, aux)


def _attend_decode(x, p, cfg, k_cache, v_cache, cur_len):
    """The attention half of a block for one new token x (b, 1, d_model)
    at position cur_len − 1 (cur_len: int32 on the device, counting this
    token): write its k and v into the caches in place at that slot, then
    attend the cur_len valid entries through flash_decode."""
    q, k, v = _qkv_heads(x, p, cfg)
    slot = (cur_len - 1).reshape(1)
    # The cache holds rotated keys, so only the new entry is rotated.
    q, k = _maybe_rope(q, k, cfg, slot)
    k_cache.index_copy_(2, slot.long(), k)
    v_cache.index_copy_(2, slot.long(), v)
    return _project(x, flash_decode(q, k_cache, v_cache, cur_len, window=cfg.window), p)


def _block_decode(x, p, cfg, k_cache, v_cache, cur_len):
    """One block for one new token; the MoE's aux loss is dropped."""
    return _finish_block(_attend_decode(x, p, cfg, k_cache, v_cache, cur_len), p)[0]


def _embed(params, tokens, cfg, start=0, length=None):
    """Token embeddings (b, t, d_model) of the positions [start, start + t)
    of a sequence of `length` tokens (t by default), plus the learned
    positions unless the config uses RoPE."""
    t = tokens.shape[1]
    length = t if length is None else length
    if length > cfg.max_len:
        raise ValueError(f"sequence length {length} exceeds max_len "
                         f"{cfg.max_len}")
    x = params["embed"][tokens]
    return x if cfg.rope else x + params["pos"][start:start + t]


def _forward_impl(params, tokens, cfg, attention, mesh=None):
    """(float32 logits, the blocks' aux loss averaged over n_layers; 0.0
    for a dense config)."""
    if mesh is not None and len(mesh.axis_names) != 2:
        raise ValueError(
            f"forward() expects a 2-axis mesh — (data, model) for the "
            f"heads layout, (data, seq) for attn_parallel='seq' — got "
            f"axes {mesh.axis_names}")
    start, length = 0, tokens.shape[1]
    if mesh is not None and cfg.attn_parallel == "seq":
        if attention is not flash_attention:
            raise ValueError("the seq layout attends through ring_attention, whose "
                             "chunk step is flash_attention_with_lse; it takes no "
                             "attention=")
        n, c = _seq_chunk(mesh)
        start, length = c * tokens.shape[1], n * tokens.shape[1]
    x, aux_total = _embed(params, tokens, cfg, start, length), 0.0
    for blk in params["blocks"]:
        x, aux = _block(x, blk, cfg, attention, mesh=mesh)
        aux_total = aux_total + aux
    return (x @ params["embed"].T).float(), aux_total / max(1, cfg.n_layers)


def _check_capture(capture: bool, tensor: torch.Tensor, what: str) -> None:
    if capture and not tensor.is_cuda:
        raise ValueError(f"capture needs a CUDA {what}, got one on {tensor.device}")


def forward_key(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> tuple:
    """The key of ``forward``'s cached graph: cfg, the tokens' layout (they
    are copied in) and the storage of every parameter (read in place)."""
    return graphs.graph_key((cfg,), copied=(tokens,), read=params)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attention=flash_attention, mesh=None, capture: bool | None = None) -> torch.Tensor:
    """float32 logits (batch, seq, vocab) for integer tokens (batch, seq).

    capture: True runs the forward as the CUDA graph ``ops.graphs`` caches
    under ``forward_key``, the counterpart of the reference's jitted
    forward: captured on the first call for the key (whose eager warm-up
    gives that call's logits), replayed on every later one; the logits are
    the caller's either way, and a parameter updated in place is read at
    its new value. It needs CUDA tokens, the default attention, no mesh and
    no parameter that requires grad under grad mode (else ValueError).
    False runs the eager body. None (the default) is True exactly where
    those hold. A failed capture or replay raises; nothing falls back.

    attention: called as ``attention(q, k, v, causal=True, window=...)``;
    the default is the port's flash_attention. Passing ``attention_plain``
    gives the same forward with the kernel's plain version, which is how
    the kernel's run is checked on the card.

    mesh: a (data, model) ``parallel.mesh.Mesh``, with params this rank's
    shards and tokens this rank's rows of the batch; the logits are this
    rank's rows, whole over the vocab. Every rank of a model group must
    call it together (its collectives). In the seq layout a (data, seq)
    mesh, params whole and tokens this rank's rows and chunk of positions
    (``parallel.mesh.shard_tokens(..., seq=True)``); the logits are that
    chunk's, and every rank of a seq group must call it together.
    """
    differentiable = torch.is_grad_enabled() and any(t.requires_grad for t in graphs.leaves(params))
    eligible = attention is flash_attention and mesh is None and not differentiable
    if capture is None:
        capture = tokens.is_cuda and eligible
    if capture and not eligible:
        raise ValueError("a captured forward takes the default attention, no mesh and no "
                         "parameter that requires grad")
    _check_capture(capture, tokens, "batch")
    if not capture:
        return _forward_impl(params, tokens, cfg, attention, mesh)[0]

    @torch.no_grad()
    def program(static_tokens):
        return _forward_impl(params, static_tokens, cfg, flash_attention)[0]

    return graphs.replayed("forward", forward_key(params, tokens, cfg), program, (tokens,))


def _empty_caches(params: dict, b: int, cfg: TransformerConfig, device) -> list:
    """One (k, v) cache pair a layer, uninitialised: (B, kv_heads, max_len,
    d_head) each, in the projections' dtype."""
    shape = (b, cfg.kv_heads, cfg.max_len, cfg.d_head)
    return [tuple(torch.empty(shape, dtype=blk["wqkv"].dtype, device=device) for _ in "kv")
            for blk in params["blocks"]]


def _prefill_into(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
                  caches: list) -> torch.Tensor:
    """``prefill`` into the given caches, in place: their first t0 slots
    set to the prompt's keys and values, the rest zeroed. Returns the
    logits at the prompt's last position."""
    t0 = prompt.shape[1]
    x = _embed(params, prompt, cfg)
    for blk, (kc, vc) in zip(params["blocks"], caches, strict=True):
        x, _aux, k, v = _block(x, blk, cfg, flash_attention, return_kv=True)
        for cache, new in ((kc, k), (vc, v)):
            cache[:, :, :t0] = new
            cache[:, :, t0:].zero_()
    return (x[:, -1] @ params["embed"].T).float()


def prefill(params: dict, prompt: torch.Tensor, cfg: TransformerConfig):
    """(float32 logits (B, vocab) at the prompt's last position, caches).

    Runs the full forward over the prompt (B, t0) and keeps each layer's
    post-RoPE k and v in a zero-filled cache pair of the fixed shape
    (B, kv_heads, max_len, d_head), the first t0 slots set.
    """
    caches = _empty_caches(params, prompt.shape[0], cfg, prompt.device)
    return _prefill_into(params, prompt, cfg, caches), caches


def decode_step(params: dict, caches: list, token: torch.Tensor,
                cur_len: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """float32 logits (B, vocab) for one new token per sequence.

    token (B,) sits at position cur_len, a 0-dim int32 tensor on the device
    counting the tokens already in the caches; the step writes its k and v
    at that slot of every layer's caches, in place. Nothing here reads a
    device value on the host, so the step can be captured as one CUDA graph
    and replayed at any length by writing cur_len.
    """
    x = params["embed"][token][:, None, :]
    if not cfg.rope:
        x = x + params["pos"].index_select(0, cur_len.reshape(1).long())
    for blk, (kc, vc) in zip(params["blocks"], caches, strict=True):
        x = _block_decode(x, blk, cfg, kc, vc, cur_len + 1)
    return (x[:, -1] @ params["embed"].T).float()


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
             n_new: int, generator: torch.Generator | None = None,
             temperature: float | torch.Tensor | None = None) -> torch.Tensor:
    """Autoregressive generation with a fixed-shape KV cache.

    prompt: (batch, t0) integer tokens; returns (batch, t0 + n_new). The
    prefill runs the full forward once (filling the caches); then n_new − 1
    decode steps each attend through flash_decode at a cache length held on
    the device, so every step launches the same kernels with the same
    shapes. On a CUDA prompt the prefill and the step are CUDA graphs cached
    per key (``generate_loop`` with capture=True), as the reference's jitted
    call compiles once per (prompt shape, n_new); on a CPU prompt every step
    runs eagerly.

    generator None (default): greedy argmax decoding. generator given:
    sample from softmax(logits / temperature) (temperature defaults to 1.0)
    by the Gumbel-max trick, the noise drawn from `generator` on its own
    device, which must be the prompt's on a CUDA prompt. The two
    frameworks' random streams differ, so sampled tokens do not match the
    reference's; greedy tokens do.
    """
    return generate_loop(params, prompt, cfg, n_new, generator, temperature,
                         capture=prompt.is_cuda)


def _picker(generator, temperature):
    """pick(logits) -> (B,) int64 tokens: argmax, or with a generator the
    argmax of logits / temperature plus Gumbel noise drawn from it."""

    def pick(logits):
        if generator is None:
            return logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=generator,
                       device=generator.device).to(logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return (logits / temperature + gumbel).argmax(dim=-1)

    return pick


def _decoder(params, prompt, cfg, n_new, pick):
    """(start, step, out) on static buffers, all allocated here and updated
    in place. start() prefills `prompt` (B, t0) into the caches, writes its
    pick (new token #1) to the token and to column 0 of out (B, n_new), and
    t0 to cur_len (0-dim int32 on the device); each step() is one decode
    step: the model step on the last token at the length cur_len, its pick
    written to the token and to column cur_len − t0 + 1 of out through a
    device index, then cur_len + 1. Nothing is read on the host, and every
    buffer a replay of either reads is the one its capture saw, so writing
    another prompt of this shape into `prompt` and replaying start, then
    step, generates from it."""
    b, t0 = prompt.shape
    caches = _empty_caches(params, b, cfg, prompt.device)
    token = torch.empty((b,), dtype=torch.long, device=prompt.device)
    out = torch.empty((b, n_new), dtype=prompt.dtype, device=prompt.device)
    cur_len = torch.empty((), dtype=torch.int32, device=prompt.device)

    def start():
        token.copy_(pick(_prefill_into(params, prompt, cfg, caches)))
        out[:, 0] = token
        cur_len.fill_(t0)

    def step():
        nxt = pick(decode_step(params, caches, token, cur_len, cfg))
        token.copy_(nxt)
        column = (cur_len - (t0 - 1)).reshape(1).long()
        out.index_copy_(1, column, nxt[:, None].to(out.dtype))
        cur_len.add_(1)

    return start, step, out


def generate_key(params: dict, prompt: torch.Tensor, cfg: TransformerConfig, n_new: int,
                 sampled: bool) -> tuple:
    """The key of ``generate``'s cached graphs: cfg, n_new, greedy or
    sampled, the prompt's layout (it is copied in) and the storage of every
    parameter (read in place). The temperature is a device operand and the
    generator's state is copied in, so neither is part of it."""
    return graphs.graph_key((cfg, n_new, sampled), copied=(prompt,), read=params)


class _CapturedDecoder:
    """``generate``'s two graphs for one key: the decoder's start (the
    prefill and the first pick) and its step, on the static buffers of one
    ``_decoder``. The prompt and the temperature are copied in; a sampled
    decoder draws from a CUDA generator of its own, registered with both
    graphs, whose state is the caller's generator's, copied in before a
    call and back out after it."""

    def __init__(self, params, prompt, cfg, n_new, sampled):
        self.prompt = torch.empty_like(prompt)
        self.temperature = torch.ones((), dtype=torch.float32, device=prompt.device)
        self.generator = torch.Generator(device=prompt.device) if sampled else None
        *self.bodies, self.out = _decoder(params, self.prompt, cfg, n_new,
                                          _picker(self.generator, self.temperature))
        self.start = self.step = None  # the bodies' graphs' counted replays

    def __call__(self, prompt, temperature, generator, n_new):
        """Generate n_new tokens from `prompt`: on the first call each
        graph's eager warm-up is its first run (the prefill, then the first
        step) before its capture; later calls replay from the prefill on."""
        self.prompt.copy_(prompt)
        self.temperature.copy_(temperature)
        if generator is not None:
            self.generator.set_state(generator.get_state())
        steps = n_new - 1
        if self.start is None:
            registered = () if self.generator is None else (self.generator,)
            start, step = self.bodies
            _, self.start, _, _ = graphs.capture(start, registered)
            if steps:
                _, self.step, _, _ = graphs.capture(step, registered)
                steps -= 1
        else:
            self.start()
        for _ in range(steps):
            self.step()
        if generator is not None:
            generator.set_state(self.generator.get_state())
        return torch.cat([prompt, self.out], dim=1)


@torch.no_grad()
def generate_loop(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
                  n_new: int, generator: torch.Generator | None = None,
                  temperature: float | torch.Tensor | None = None, *,
                  capture: bool) -> torch.Tensor:
    """``generate``'s body, run eagerly or as cached graphs by `capture`.

    capture=False runs the prefill and every decode step eagerly.
    capture=True (a CUDA prompt only) runs them as the graphs ``ops.graphs``
    caches under ``generate_key``: on the first call for the key the
    prefill and the first step each run eagerly on the capture stream and
    are then captured; every later call replays the prefill graph and then
    the step graph once per further token, capturing nothing. The launch
    counts follow the replays. Both give the same tokens: the same kernels
    on the same inputs, and the noise drawn at the generator's own offsets,
    which advance as an eager call's would. A failed capture or replay
    raises; nothing falls back to the eager loop.
    """
    if n_new < 0:
        raise ValueError(f"n_new must be >= 0, got {n_new}")
    _check_capture(capture, prompt, "prompt")
    if n_new == 0:
        return prompt
    if prompt.shape[1] + n_new > cfg.max_len:
        raise ValueError(f"prompt ({prompt.shape[1]}) + n_new ({n_new}) "
                         f"exceeds max_len ({cfg.max_len})")
    if temperature is not None and generator is None:
        raise ValueError("temperature without a generator would be "
                         "silently ignored; pass generator= to sample")
    if (generator is not None and isinstance(temperature, (int, float))
            and not temperature > 0):  # `not >` also rejects NaN
        raise ValueError(f"temperature must be > 0, got {temperature}")
    # A graph records one host-to-device copy of a CPU generator's noise and
    # would replay that same noise at every step.
    if capture and generator is not None and (
            generator.device.type != prompt.device.type
            or generator.device.index not in (None, prompt.device.index)):
        raise ValueError(f"a captured loop draws its noise on the prompt's "
                         f"device {prompt.device}; the generator is on "
                         f"{generator.device}")
    if temperature is None:
        temperature = 1.0
    # A tensor temperature bypasses the check above: floor it, as the
    # reference does, so 0, negative or NaN cannot poison the logits.
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=prompt.device)
    temperature = torch.where(temperature > 0, temperature,
                              torch.full_like(temperature, 1e-6))
    if capture:
        sampled = generator is not None
        key = generate_key(params, prompt, cfg, n_new, sampled)
        decoder = graphs.lookup("generate", key)
        if decoder is not None:
            return decoder(prompt, temperature, generator, n_new)
        decoder = _CapturedDecoder(params, prompt, cfg, n_new, sampled)
        tokens = decoder(prompt, temperature, generator, n_new)
        graphs.store("generate", key, decoder)
        return tokens
    start, step, out = _decoder(params, prompt, cfg, n_new, _picker(generator, temperature))
    start()
    for _ in range(n_new - 1):
        step()
    return torch.cat([prompt, out], dim=1)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The negative log-likelihoods (B, T, 1) of targets (B, T) under
    logits (B, T, V)."""
    return -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits (B, T, V) against
    tokens (B, T), shifted by one."""
    return _nll(logits[:, :-1], tokens[:, 1:]).mean()


def loss_fn(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            attention=flash_attention, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward`` on tokens (B, T), a
    0-dim float32 tensor, plus moe_aux_weight x the mean load-balancing
    loss for MoE configs. attention as in ``forward``.

    Under a mesh, this rank's share: the mean over its rows of the batch,
    and the aux loss with each expert's routed fraction taken over the
    whole batch (``parallel.moe.moe_ffn``). The mean of the shares over
    the data axis is the loss of the whole batch, and the mean of their
    gradients its gradient (``parallel.train_step.loss_and_grads``).

    In the seq layout, tokens are this rank's rows whole (B/dp, L): the
    rank runs its chunk of positions and scores each against the next
    token, which for the chunk's last position is the next chunk's first
    (the last chunk has one position fewer). Its share is its NLLs summed
    over the whole batch's count B·(L − 1), plus its aux loss over the
    dp·sp ranks; the shares sum to the loss of the whole batch, and their
    gradients to its gradient."""
    if mesh is None or cfg.attn_parallel == "heads":
        logits, aux = _forward_impl(params, tokens, cfg, attention, mesh)
        loss = next_token_nll(logits, tokens)
    else:
        dp, (sp, c) = mesh.size(mesh.axis_names[0]), _seq_chunk(mesh)
        rows, length = tokens.shape
        check_seq_split((rows * dp, length), mesh)
        chunk = length // sp
        start = c * chunk
        logits, aux = _forward_impl(params, tokens[:, start:start + chunk], cfg,
                                    attention, mesh)
        scored = min(chunk, length - 1 - start)
        nll = _nll(logits[:, :scored], tokens[:, start + 1:start + 1 + scored])
        loss = nll.sum() / (rows * dp * (length - 1))
        aux = aux / (dp * sp)
    if cfg.n_experts is not None:
        loss = loss + cfg.moe_aux_weight * aux
    return loss
