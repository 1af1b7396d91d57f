"""The port's attention against the JAX reference on the CPU.

``attention_plain`` (what the port runs for CPU tensors, and what the CUDA
kernel is held to on the card) against the oracle ``_xla_attention`` and the
Pallas ``_flash_kernel`` in interpret mode, on the same numpy inputs; the
public entry's argument checks against the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpumounter_tpu.ops.flash_attention import (
    _xla_attention, flash_attention as jax_flash_attention,
    flash_attention_pallas)
from gpumounter_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _qkv(b, h, h_kv, l_q, l_k, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, l_q, d)).astype(np.float32)
    k = rng.normal(size=(b, h_kv, l_k, d)).astype(np.float32)
    v = rng.normal(size=(b, h_kv, l_k, d)).astype(np.float32)
    return q, k, v


# (h, h_kv, l_q, l_k, causal, window, softcap, sinks)
ORACLE_CASES = {
    "causal": (4, 4, 48, 48, True, None, None, 0),
    "non_causal": (4, 4, 48, 48, False, None, None, 0),
    "window": (4, 4, 48, 48, True, 7, None, 0),
    "window_sinks": (4, 4, 48, 48, True, 7, None, 3),
    "softcap": (4, 4, 48, 48, True, None, 2.0, 0),
    "gqa_group2": (4, 2, 48, 48, True, None, None, 0),
    "gqa_group4": (4, 1, 48, 48, True, 9, None, 2),
    "causal_cross_length": (4, 4, 16, 48, True, None, None, 0),
    "non_causal_cross_length": (4, 4, 20, 52, False, None, None, 0),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_plain_matches_xla_oracle(case):
    h, h_kv, l_q, l_k, causal, window, softcap, sinks = ORACLE_CASES[case]
    q, k, v = _qkv(2, h, h_kv, l_q, l_k, 16)
    scale = 0.3
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, scale, window, softcap, sinks)
    got = tfa.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, scale, window,
                              softcap, sinks)
    # f32 throughout on both sides; only the summation order differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", [
    # (b, h, h_kv, l_q, l_k, window, sinks)
    (1, 2, 2, 32, 32, None, 0),
    (1, 4, 2, 32, 64, 9, 3),    # GQA, decode offset, window + sinks
])
def test_plain_lse_matches_pallas_kernel(case):
    b, h, h_kv, l_q, l_k, window, sinks = case
    q, k, v = _qkv(b, h, h_kv, l_q, l_k, 16, seed=1)
    o, lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        scale=0.25, block_q=16, block_k=16, interpret=True, return_lse=True,
        window=window, sinks=sinks)
    got_o, got_lse = tfa.flash_attention_kernel(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, scale=0.25, window=window, sinks=sinks, return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5,
                               rtol=1e-5)


def test_band_mask_rules():
    # Queries at the last 3 of 10 key positions (p = 7, 8, 9), window 2,
    # one sink: keys [p-2, p] plus key 0.
    keep = tfa._band_mask(3, 10, window=2, sinks=1, device="cpu")
    assert [row.nonzero().flatten().tolist() for row in keep] == [
        [0, 5, 6, 7], [0, 6, 7, 8], [0, 7, 8, 9]]


@pytest.mark.parametrize("kwargs", [
    dict(softcap=0.0),
    dict(softcap=-1.0),
    dict(sinks=-1, window=4),
    dict(sinks=2),
    dict(window=4, causal=False),
    dict(window=-1),
    dict(causal_cross=True),
])
def test_public_entry_refuses_like_reference(kwargs):
    kwargs = dict(kwargs)
    l_k = 24 if kwargs.pop("causal_cross", False) else 16
    q, k, v = _qkv(1, 2, 2, 16, l_k, 8)
    with pytest.raises(ValueError) as want:
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kwargs)
    with pytest.raises(ValueError) as got:
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kwargs)
    # Same message, up to where the reference names its own decode entry.
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_public_entry_matches_oracle_on_cpu():
    q, k, v = _qkv(2, 4, 2, 40, 40, 16, seed=2)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          True, 0.25, 5, 3.0, 1)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.25, window=5,
                              softcap=3.0, sinks=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 16, 16, 8))
    before = tfa.flash_attention_kernel.launches
    got = tfa.flash_attention_kernel(q, k, v, causal=True)
    assert tfa.flash_attention_kernel.launches == before
    torch.testing.assert_close(got, tfa.attention_plain(q, k, v, True))


def test_kernel_rejects_mixed_devices():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 16, 16, 8))
    with pytest.raises(ValueError, match="different devices"):
        tfa.flash_attention_kernel(q, k.to("meta"), v)


@pytest.mark.parametrize("mutate, match", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), "bfloat16 or float32"),
    (lambda q, k, v: (q, k.float(), v), "dtypes differ"),
    (lambda q, k, v: (q[..., :48], k[..., :48], v[..., :48]), "head dim"),
    (lambda q, k, v: (q.transpose(2, 3), k, v), "contiguous in the head dim"),
    (lambda q, k, v: (q, k.transpose(2, 3).contiguous().transpose(2, 3), v),
     "contiguous in the head dim"),
    (lambda q, k, v: (q, k, v[:, :, 1:]), "one shape"),
    (lambda q, k, v: (q[:, :, :0], k, v), "L_q, L_k >= 1"),
])
def test_kernel_input_checks(mutate, match):
    """What flash_fwd.cu cannot take raises before any launch (checked here
    on CPU tensors; the CUDA path runs the same checks)."""
    q, k, v = (torch.randn(2, 4, 64, 64, dtype=torch.bfloat16)
               for _ in range(3))
    with pytest.raises(ValueError, match=match):
        tfa._check_kernel_inputs(*mutate(q, k, v))


@pytest.mark.parametrize("mutate, match", [
    (lambda q, k, v: (q, k[:, :, :1].expand(-1, -1, 64, -1), v), "broadcast"),
    (lambda q, k, v: (q, k, v[:, :1].expand(-1, 4, -1, -1)), "broadcast"),
    (lambda q, k, v: (torch.zeros(1, 1, 1, 64, dtype=q.dtype)
                      .expand(1, 1, 128 * 65535 + 1, 64), k[:1, :1], v[:1, :1]),
     "grid column per 128 query rows"),
    (lambda q, k, v: (torch.randn(2, 4, 64, 72, dtype=q.dtype)[..., 1:65], k, v),
     "16-byte"),
    (lambda q, k, v: (q, torch.randn(2, 4, 64, 68, dtype=q.dtype)[..., :64], v),
     "16-byte"),
])
def test_kernel_input_checks_for_tma(mutate, match):
    """bf16 q/k/v are read by TMA tensor maps: a 16-byte-aligned base and
    16-byte-multiple strides, no broadcast dim, and no more than 65535
    tiles of 128 query rows."""
    q, k, v = (torch.randn(2, 4, 64, 64, dtype=torch.bfloat16)
               for _ in range(3))
    with pytest.raises(ValueError, match=match):
        tfa._check_kernel_inputs(*mutate(q, k, v))


def test_tma_rules_leave_f32_alone():
    # f32 takes the scalar path, which reads a broadcast view by its strides.
    q, k, v = (torch.randn(2, 4, 64, 64) for _ in range(3))
    tfa._check_kernel_inputs(q, k[:, :, :1].expand(-1, -1, 64, -1), v)


def test_kernel_input_checks_accept_probe_views():
    # The probe's q/k/v are head-split transposes of one projection; the
    # kernel reads them strided, without a copy.
    qkv = torch.randn(2, 64, 3 * 4 * 32, dtype=torch.bfloat16)
    q, k, v = (a.reshape(2, 64, 4, 32).transpose(1, 2)
               for a in qkv.split(128, dim=-1))
    tfa._check_kernel_inputs(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_kernel_inputs(qkv[..., 1:129].reshape(2, 64, 4, 32)
                                 .transpose(1, 2), k, v)
