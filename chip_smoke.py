"""Drive the PyTorch/CUDA port on one card and hold it to its plain versions.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):

1. build every kernel of the port from ``gpumounter_tpu_torch/ops/csrc``
   with nvcc (sm_90a) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, case by
   case, with the tolerance stated beside each;
3. run the main path — the probe's forward at full width (the config of the
   repo's train-step bench: vocab 2048, d_model 1024, 8 heads of 128, 2
   layers, d_ff 4096, rope, bf16) on 3 batches of 4 x 2048 random tokens —
   with the launch counts set to 0 just before and read just after, and
   hold its logits against the same forward with the plain attention;
4. time each kernel, its plain version and the PyTorch library call that
   computes the same function, and the whole forward, with CUDA events.

The last lines are a JSON object per kernel (``{"kernels": [...]}``) and
``{"ok": true, "device": {...}}``. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from gpumounter_tpu_torch.models.probe import (TransformerConfig, forward,
                                               init_params, next_token_nll)
from gpumounter_tpu_torch.ops import _build
from gpumounter_tpu_torch.ops.flash_attention import (attention_plain,
                                                      flash_attention_kernel)

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the bf16 tensor-core rate and its bytes
# (each input read once, each output written once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FULL = dict(B=4, H=8, L=2048, D=128)
# bf16 output: 1 ulp is 2^-8 relative; the kernel also rounds P to bf16
# before P·V (as the TPU kernel does) where the plain version keeps f32.
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
LSE_ATOL = 1e-4  # lse is f32 from f32 scores on both sides
# Logits of the full forward: attention outputs that differ by ~1 bf16 ulp
# pass through two layers of bf16 matmuls and residual adds.
LOGITS_RTOL_OF_MAX = 2e-2
NLL_ATOL = 1e-3  # the mean over 4 x 2047 positions smooths those errors
NLL_ABOVE_UNIFORM = 0.5


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters runs, with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_bound_ms(b, h, l_q, l_k, d, itemsize, causal=True):
    """Least time for the attention forward: 4·D operations per attended
    (query, key) pair — here all pairs of the causal band, L(L+1)/2 per
    head when L_q == L_k — against q/k/v/o bytes."""
    pairs = l_q * (2 * l_k - l_q + 1) // 2 if causal else l_q * l_k
    flops = 4 * d * b * h * pairs
    nbytes = itemsize * d * b * h * (2 * l_q + 2 * l_k)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_build(card: str) -> None:
    print(card, flush=True)
    t0 = time.perf_counter()
    paths = _build.build(["flash_fwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(p.name for p in paths.values())})",
          flush=True)


def phase_kernel_vs_plain(gen) -> float:
    """Each case runs the kernel and the plain version on the same inputs;
    returns the max abs error of the full-width causal case."""

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    cases = [  # (name, (B, H, H_kv, L_q, L_k, D), kwargs, dtype)
        ("causal B4 H8 L2048 D128", (b, h, h, l, l, d), dict(causal=True), torch.bfloat16),
        ("GQA H_kv=2", (b, h, 2, l, l, d), dict(causal=True), torch.bfloat16),
        ("window 255", (b, h, h, l, l, d), dict(causal=True, window=255), torch.bfloat16),
        ("window 255 + sinks 4", (b, h, h, l, l, d), dict(causal=True, window=255, sinks=4), torch.bfloat16),
        ("softcap 30", (b, h, h, l, l, d), dict(causal=True, softcap=30.0), torch.bfloat16),
        ("return_lse", (b, h, h, l, l, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("causal cross-length L_q=128 L_k=2048", (b, h, h, 128, l, d), dict(causal=True, return_lse=True), torch.bfloat16),
        ("D=32", (b, h, h, l, l, 32), dict(causal=True), torch.bfloat16),
        ("D=64", (b, h, h, l, l, 64), dict(causal=True), torch.bfloat16),
        ("ragged L=1000", (b, h, h, 1000, 1000, d), dict(causal=True), torch.bfloat16),
        ("non-causal L_q=300 L_k=700 D=64", (2, 4, 4, 300, 700, 64), dict(causal=False), torch.bfloat16),
        ("f32 GQA window 17 + sinks 2 L=500 D=64", (2, 4, 2, 500, 500, 64), dict(causal=True, window=17, sinks=2, return_lse=True), torch.float32),
    ]
    full_err = None
    for name, (cb, ch, chk, lq, lk, cd), kw, dtype in cases:
        q = rand(cb, ch, lq, cd, dtype=dtype)
        k = rand(cb, chk, lk, cd, dtype=dtype)
        v = rand(cb, chk, lk, cd, dtype=dtype)
        got = flash_attention_kernel(q, k, v, **kw)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        want = attention_plain(q, k, v, **kw)
        if kw.get("return_lse"):
            (got, got_lse), (want, want_lse) = got, want
            lse_err = (got_lse - want_lse).abs().max().item()
            if not lse_err <= LSE_ATOL:
                raise RuntimeError(f"{name}: lse max abs err {lse_err} > {LSE_ATOL}")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        bad = diff > tol["atol"] + tol["rtol"] * want.float().abs()
        if not torch.isfinite(got).all() or bad.any():
            raise RuntimeError(f"{name}: kernel vs plain max abs err {err} "
                               f"beyond atol {tol['atol']} + rtol {tol['rtol']}")
        lse_note = f", lse err {lse_err:.3g}" if kw.get("return_lse") else ""
        print(f"case {name}: max abs err {err:.3g} (atol {tol['atol']}, rtol {tol['rtol']}){lse_note}",
              flush=True)
        if full_err is None:
            full_err = err
    return full_err


def full_width_config() -> TransformerConfig:
    return TransformerConfig(vocab=2048, d_model=1024, n_heads=8, n_layers=2,
                             d_ff=4096, max_len=FULL["L"], rope=True,
                             dtype=torch.bfloat16)


def phase_main_path(cfg, params, batches) -> int:
    """Forward on each batch through the kernel; returns its launch count."""
    flash_attention_kernel.launches = 0
    outs = [forward(params, tokens, cfg) for tokens in batches]
    torch.cuda.synchronize()
    launches = flash_attention_kernel.launches
    want_launches = cfg.n_layers * len(batches)
    if launches != want_launches:
        raise RuntimeError(f"flash_fwd launched {launches} times on the main "
                           f"path, expected n_layers x batches = {want_launches}")
    for i, (tokens, logits) in enumerate(zip(batches, outs)):
        if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
            raise RuntimeError(f"batch {i}: logits {tuple(logits.shape)} not "
                               f"finite of shape {(*tokens.shape, cfg.vocab)}")
        nll = next_token_nll(logits, tokens).item()
        # Random weights give near-uniform predictions: logits of std s put
        # the NLL about s²/2 above log(vocab) (s ~ 0.5 at this width).
        if not 0 <= nll - math.log(cfg.vocab) < NLL_ABOVE_UNIFORM:
            raise RuntimeError(f"batch {i}: next-token nll {nll} not within "
                               f"{NLL_ABOVE_UNIFORM} above log(vocab) = "
                               f"{math.log(cfg.vocab)}")
        plain = forward(params, tokens, cfg, attention=attention_plain)
        err = (logits - plain).abs().max().item()
        limit = LOGITS_RTOL_OF_MAX * plain.abs().max().item()
        nll_plain = next_token_nll(plain, tokens).item()
        if not (err <= limit and abs(nll - nll_plain) <= NLL_ATOL):
            raise RuntimeError(f"batch {i}: vs plain-attention forward: logits "
                               f"max abs err {err} (limit {limit}), nll {nll} "
                               f"vs {nll_plain} (limit {NLL_ATOL})")
        print(f"main path batch {i}: logits {tuple(logits.shape)} finite, nll "
              f"{nll:.4f} (log V {math.log(cfg.vocab):.4f}, plain-attention "
              f"forward {nll_plain:.4f}), logits vs plain-attention forward "
              f"max abs err {err:.3g} (limit {limit:.3g} = "
              f"{LOGITS_RTOL_OF_MAX} x max |logits|)", flush=True)
    print(f"main path: flash_fwd launches {launches} (n_layers {cfg.n_layers} "
          f"x batches {len(batches)})", flush=True)
    return launches


def phase_timings(gen, cfg, params, tokens, card) -> dict:
    b, h, l, d = FULL["B"], FULL["H"], FULL["L"], FULL["D"]
    q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ms = _time_ms(lambda: flash_attention_kernel(q, k, v, causal=True), 20)
    plain_ms = _time_ms(lambda: attention_plain(q, k, v, causal=True), 5)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    bound_ms, bound_by = _attention_bound_ms(b, h, l, l, d, q.element_size())
    print(f"time flash_fwd B{b} H{h} L{l} D{d} causal bf16: kernel {ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms [{card}]", flush=True)
    fwd_ms = _time_ms(lambda: forward(params, tokens, cfg), 5, warmup=1)
    tok_s = tokens.numel() / (fwd_ms / 1e3)
    print(f"time forward B{tokens.shape[0]} L{tokens.shape[1]}: {fwd_ms:.3f} ms, "
          f"{tok_s:.0f} tokens/s [{card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    phase_build(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs_err = phase_kernel_vs_plain(gen)

    cfg = full_width_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (FULL["B"], FULL["L"]))).cuda()
               for _ in range(3)]
    launches = phase_main_path(cfg, params, batches)
    times = phase_timings(gen, cfg, params, batches[0], card)

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "gpumounter_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "gpumounter_tpu/ops/flash_attention.py:84",
        "launches": launches, "max_abs_err": max_abs_err, **times}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
