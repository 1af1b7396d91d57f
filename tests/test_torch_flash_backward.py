"""The port's attention backward against the JAX reference on the CPU.

``attention_bwd_plain`` (what the port runs for CPU tensors, and what the
CUDA backward kernels are held to on the card) against ``jax.vjp`` of the
oracle ``_xla_attention`` with its lse; the autograd Function against the
reference's ``flash_attention_with_lse``, whose backward runs the Pallas
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` in interpret mode;
grads through the public entry; the backward wrapper's input checks.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpumounter_tpu.ops.flash_attention import (
    NEG_INF, _softcap, _xla_attention,
    flash_attention_with_lse as jax_flash_attention_with_lse)
from gpumounter_tpu_torch.ops import flash_attention as tfa

from test_torch_flash_attention import ORACLE_CASES, _qkv


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _jax_attention_with_lse(q, k, v, causal, scale, window, softcap, sinks):
    """(_xla_attention, the log-sum-exp of its masked scores)."""
    o = _xla_attention(q, k, v, causal, scale, window, softcap, sinks)
    kr = jnp.repeat(k, q.shape[1] // k.shape[1], axis=1)
    s = _softcap(jnp.einsum("bhqd,bhkd->bhqk", q, kr) * scale, softcap)
    if causal:
        l_q, l_k = q.shape[2], k.shape[2]
        q_pos = (l_k - l_q) + jnp.arange(l_q)[:, None]
        keys = jnp.arange(l_k)[None, :]
        keep = keys <= q_pos
        if window is not None:
            in_band = keys >= q_pos - window
            if sinks:
                in_band = in_band | (keys < sinks)
            keep = keep & in_band
        s = jnp.where(keep, s, NEG_INF)
    return o, jax.nn.logsumexp(s, axis=-1)


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_plain_backward_matches_oracle_vjp(case):
    h, h_kv, l_q, l_k, causal, window, softcap, sinks = ORACLE_CASES[case]
    q, k, v = _qkv(2, h, h_kv, l_q, l_k, 16)
    rng = np.random.default_rng(7)
    do = rng.normal(size=q.shape).astype(np.float32)
    dlse = rng.normal(size=q.shape[:3]).astype(np.float32)
    scale = 0.3
    _, vjp = jax.vjp(
        lambda q, k, v: _jax_attention_with_lse(q, k, v, causal, scale,
                                                window, softcap, sinks),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv, tdo, tdlse = _torch(q, k, v, do, dlse)
    o, lse = tfa.attention_plain(tq, tk, tv, causal, scale, window, softcap,
                                 sinks, return_lse=True)
    got = tfa.attention_bwd_plain(tq, tk, tv, o, lse, tdo, tdlse,
                                  causal=causal, scale=scale, window=window,
                                  softcap=softcap, sinks=sinks)
    # f32 throughout on both sides; only the summation order differs.
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", [
    # (b, h, h_kv, l_q, l_k, window, sinks, softcap)
    (1, 2, 2, 32, 32, None, 0, 5.0),
    (1, 4, 2, 32, 64, 9, 3, None),    # GQA, decode offset, window + sinks
])
def test_function_matches_pallas_backward_kernels(case):
    """Loss Σo² + 0.1·Σlse, so the lse cotangent is folded into Δ."""
    b, h, h_kv, l_q, l_k, window, sinks, softcap = case
    q, k, v = _qkv(b, h, h_kv, l_q, l_k, 16, seed=3)
    scale = 0.25

    def jax_loss(q, k, v):
        o, lse = jax_flash_attention_with_lse(q, k, v, True, scale, 16, 16,
                                              True, window, softcap, sinks)
        return jnp.sum(o ** 2) + 0.1 * jnp.sum(lse)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, scale=scale,
                                          window=window, softcap=softcap,
                                          sinks=sinks)
    got = torch.autograd.grad((o ** 2).sum() + 0.1 * lse.sum(), (tq, tk, tv))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_public_entry_grads_match_oracle():
    q, k, v = _qkv(2, 4, 2, 40, 40, 16, seed=2)
    weight = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(
        _xla_attention(q, k, v, True, 0.25, 5, 3.0, 1) * weight),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, scale=0.25, window=5, softcap=3.0,
                              sinks=1)
    assert type(out.grad_fn).__name__ == "_FlashAttentionFnBackward"
    got = torch.autograd.grad((out * torch.from_numpy(weight)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_public_entry_without_grad_takes_the_no_lse_kernel_path():
    tq, tk, tv = _torch(*_qkv(1, 2, 2, 16, 16, 8), grad=True)
    with torch.no_grad():
        out = tfa.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    plain = _torch(*_qkv(1, 2, 2, 16, 16, 8))
    assert tfa.flash_attention(*plain).grad_fn is None


def test_function_backward_runs_the_plain_backward_on_cpu(monkeypatch):
    """On the CPU the Function's backward is attention_bwd_plain (the
    formula the card's kernels are held to), not autograd through
    attention_plain, and launches nothing."""
    calls = []
    real = tfa.attention_bwd_plain

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "attention_bwd_plain", spy)
    before = (tfa.flash_attention_bwd_kernel.dq_launches,
              tfa.flash_attention_bwd_kernel.dkv_launches)
    tq, tk, tv = _torch(*_qkv(1, 4, 2, 24, 24, 8), grad=True)
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, window=6, sinks=2)
    assert o.grad_fn is lse.grad_fn  # one node, no graph through the plain
    (o.sum() + lse.sum()).backward()
    assert len(calls) == 1 and calls[0]["window"] == 6
    assert (tfa.flash_attention_bwd_kernel.dq_launches,
            tfa.flash_attention_bwd_kernel.dkv_launches) == before
    assert tk.grad.shape == tk.shape


def test_only_lse_used_gives_zero_do():
    """Autograd hands the backward zeros for the unused output."""
    tq, tk, tv = _torch(*_qkv(1, 2, 2, 16, 16, 8), grad=True)
    _, lse = tfa.flash_attention_with_lse(tq, tk, tv)
    dq, dk, dv = torch.autograd.grad(lse.sum(), (tq, tk, tv))
    assert torch.all(dv == 0) and dq.abs().max() > 0 and dk.abs().max() > 0


def _bwd_inputs(d=64, dtype=torch.bfloat16):
    q, k, v, o, do = (torch.randn(2, 4, 64, d, dtype=dtype) for _ in range(5))
    lse = torch.randn(2, 4, 64)
    return q, k, v, o, lse, do, None


@pytest.mark.parametrize("mutate, match", [
    (lambda a: (*(t.half() for t in a[:4]), a[4], a[5].half(), None),
     "bfloat16 or float32"),
    (lambda a: (*a[:5], a[5].float(), None), "do must match"),
    (lambda a: (*a[:3], a[3][:, :, 1:], *a[4:]), "o must match"),
    (lambda a: (*a[:4], a[4][..., 1:], *a[5:]), "lse must be"),
    (lambda a: (*a[:6], torch.zeros(2, 4, 63)), "dlse must be"),
])
def test_backward_input_checks(mutate, match):
    """What flash_bwd.cu cannot take raises before any launch (checked here
    on CPU tensors; the CUDA path runs the same checks)."""
    with pytest.raises(ValueError, match=match):
        tfa._check_bwd_inputs(*mutate(_bwd_inputs()))


def test_backward_input_checks_name_the_head_dim():
    with pytest.raises(ValueError, match="head dim"):
        tfa._check_bwd_inputs(*_bwd_inputs(d=48))


def test_backward_refuses_mixed_and_other_devices():
    q, k, v, o, lse, do, _ = _bwd_inputs()
    before = (tfa.flash_attention_bwd_kernel.dq_launches,
              tfa.flash_attention_bwd_kernel.dkv_launches)
    with pytest.raises(ValueError, match="different devices"):
        tfa.flash_attention_bwd_kernel(q, k.to("meta"), v, o, lse, do)
    meta = [t.to("meta") for t in (q, k, v, o, lse, do)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tfa.flash_attention_bwd_kernel(*meta)
    assert (tfa.flash_attention_bwd_kernel.dq_launches,
            tfa.flash_attention_bwd_kernel.dkv_launches) == before


def test_cpu_tensors_take_the_plain_backward_without_a_launch():
    q, k, v, o, lse, do, _ = _bwd_inputs(d=32, dtype=torch.float32)
    before = (tfa.flash_attention_bwd_kernel.dq_launches,
              tfa.flash_attention_bwd_kernel.dkv_launches)
    got = tfa.flash_attention_bwd_kernel(q, k, v, o, lse, do, window=7)
    assert (tfa.flash_attention_bwd_kernel.dq_launches,
            tfa.flash_attention_bwd_kernel.dkv_launches) == before
    for g, w in zip(got, tfa.attention_bwd_plain(q, k, v, o, lse, do,
                                                 window=7), strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_layout_copies_only_what_the_kernel_cannot_read():
    # The probe's do is a head-split transpose: strided, head dim contiguous.
    merged = torch.randn(2, 64, 4 * 32, dtype=torch.bfloat16)
    do = merged.reshape(2, 64, 4, 32).transpose(1, 2)
    assert tfa._kernel_layout(do) is do
    odd = torch.randn(2, 4, 32, 64, dtype=torch.bfloat16).transpose(2, 3)
    fixed = tfa._kernel_layout(odd)
    assert fixed.is_contiguous() and torch.equal(fixed, odd)


@pytest.mark.parametrize("shape", [(64, 32), (1, 4, 64, 32), (2, 1, 1, 32)])
def test_kernel_layout_copies_a_broadcast_gradient(shape):
    """A gradient handed in as w.expand_as(o) keeps w's zero strides, which
    a TMA tensor map cannot read, so it comes back as a contiguous copy.
    A zero stride on a dim of extent 1 is never stepped
    along, and the probe's head-split transpose is read in place: both
    come back as themselves."""
    w = torch.randn(shape, dtype=torch.bfloat16)
    do = w.expand(2, 4, 64, 32)
    assert 0 in do.stride()
    fixed = tfa._kernel_layout(do)
    assert fixed.is_contiguous() and torch.equal(fixed, do)
    lone = torch.randn(4, 64, 32, dtype=torch.bfloat16).as_strided((1, 4, 64, 32), (0, 64 * 32, 32, 1))
    assert tfa._kernel_layout(lone) is lone
    split = torch.randn(2, 64, 4 * 32, dtype=torch.bfloat16).reshape(2, 64, 4, 32).transpose(1, 2)
    assert tfa._kernel_layout(split) is split
