"""The port's decode attention against the JAX reference on the CPU.

The same numpy inputs go through the reference's ``flash_decode`` (its
Pallas kernel in interpret mode, ``block_k=64``) and the port's
``flash_decode_plain``, in float32, at the reference's own tolerance
(``tests/test_flash_decode.py``).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpumounter_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from gpumounter_tpu_torch.ops.flash_attention import attention_plain
from gpumounter_tpu_torch.ops.flash_decode import (flash_decode,
                                                   flash_decode_kernel,
                                                   flash_decode_plain)

TOL = dict(rtol=2e-5, atol=2e-5)  # the reference's, f32 against f32


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _setup(b=2, h=2, h_kv=2, l_max=256, l_q=1, d=64, seed=0, tail=None,
           cache_len=None):
    """q, k, v as numpy f32, as the reference's tests make them; with tail
    the cache past cache_len holds that value."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, l_q, d)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, h_kv, l_max, d)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, h_kv, l_max, d)) * 0.5).astype(np.float32)
    if tail is not None:
        k[:, :, cache_len:] = tail
        v[:, :, cache_len:] = tail
    return q, k, v


# name: (setup kwargs, cache_len, flash_decode kwargs)
REFERENCE_CASES = {
    **{f"len_{n}": ({}, n, {}) for n in (1, 37, 64, 200, 256)},
    "invalid_tail_1e9": (dict(tail=1e9, cache_len=100), 100, {}),
    "l_q8_window50": (dict(l_q=8), 200, dict(window=50)),
    "window40_sinks8": ({}, 200, dict(window=40, sinks=8)),
    "gqa_4_over_1": (dict(h=4, h_kv=1), 150, {}),
    "len_above_l_max_clipped": ({}, 300, {}),
    "len_below_l_q_clipped": (dict(l_q=8), 3, {}),
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_plain_matches_reference_kernel(case):
    setup, cache_len, kw = REFERENCE_CASES[case]
    q, k, v = _setup(**setup)
    want = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), cache_len, block_k=64,
                                       interpret=True, **kw))
    got = flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), cache_len, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (setup kwargs, cache_len, kwargs): causal cross-length on the sliced cache
SLICED_CASES = {
    "mha": ({}, 200, {}),
    "gqa_l_q4": (dict(h=4, h_kv=2, l_q=4), 77, {}),
    "window_sinks_l_q3": (dict(l_q=3), 180, dict(window=20, sinks=5)),
    "full_cache": (dict(l_q=2), 256, {}),
}


@pytest.mark.parametrize("case", list(SLICED_CASES))
def test_plain_equals_cross_length_attention_on_the_sliced_cache(case):
    setup, n, kw = SLICED_CASES[case]
    q, k, v = (torch.from_numpy(a) for a in _setup(**setup))
    got = flash_decode_plain(q, k, v, n, **kw)
    want = attention_plain(q, k[:, :, :n], v[:, :, :n], causal=True, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_tail_may_hold_anything_even_nan():
    q, k, v = (torch.from_numpy(a) for a in _setup(tail=float("nan"),
                                                   cache_len=90))
    got = flash_decode_plain(q, k, v, 90)
    want = flash_decode_plain(q, k[:, :, :90].clone(), v[:, :, :90].clone(), 90)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_length_as_tensor_or_int_agree():
    q, k, v = (torch.from_numpy(a) for a in _setup(l_q=2))
    by_int = flash_decode(q, k, v, 123, window=30)
    for n in (torch.tensor(123, dtype=torch.int32),
              torch.tensor([123], dtype=torch.int32),
              torch.tensor(123)):
        torch.testing.assert_close(flash_decode(q, k, v, n, window=30), by_int,
                                   rtol=0, atol=0)


def test_bf16_output_dtype_and_scale():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _setup())
    got = flash_decode(q, k, v, 50, scale=0.3)
    assert got.dtype == torch.bfloat16
    want = flash_decode_plain(q.float(), k.float(), v.float(), 50, scale=0.3)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


def test_cpu_tensors_run_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _setup(h=4, h_kv=2, l_q=3))
    before = flash_decode_kernel.launches
    got = flash_decode_kernel(q, k, v, 140, window=9, sinks=2)
    assert flash_decode_kernel.launches == before  # no kernel ran
    torch.testing.assert_close(
        got, flash_decode_plain(q, k, v, 140, window=9, sinks=2),
        rtol=0, atol=0)


def test_kernel_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 1, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_decode_kernel(q, q, q, 1)


# name: (q shape, cache shape, kwargs)
BAD_ARGS = {
    "heads_not_divisible": ((1, 3, 1, 8), (1, 2, 16, 8), {}),
    "window_negative": ((1, 2, 1, 8), (1, 2, 16, 8), dict(window=-1)),
    "sinks_negative": ((1, 2, 1, 8), (1, 2, 16, 8), dict(window=4, sinks=-1)),
    "sinks_without_window": ((1, 2, 1, 8), (1, 2, 16, 8), dict(sinks=2)),
    "l_q_above_capacity": ((1, 2, 17, 8), (1, 2, 16, 8), {}),
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_argument_checks_match_reference(case):
    q_shape, kv_shape, kw = BAD_ARGS[case]
    q, kv = np.zeros(q_shape, np.float32), np.zeros(kv_shape, np.float32)
    with pytest.raises(ValueError) as want:
        jax_flash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), 4,
                         interpret=True, **kw)
    with pytest.raises(ValueError) as got:
        flash_decode(torch.from_numpy(q), torch.from_numpy(kv),
                     torch.from_numpy(kv), 4, **kw)
    assert str(got.value) == str(want.value)
