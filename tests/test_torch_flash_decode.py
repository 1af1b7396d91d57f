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
from gpumounter_tpu_torch.ops.flash_decode import (CHUNK_ROWS, GRID_YZ_MAX,
                                                   _check_kernel_inputs,
                                                   _launch_plan, flash_decode,
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
    # Beyond one kernel block's 64 rows: group 16 x l_q 8 = 128.
    "mqa_128_rows_window_sinks": (dict(h=16, h_kv=1, l_q=8), 200,
                                  dict(window=30, sinks=4)),
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


def test_kernel_checks_take_128_rows_and_refuse_a_misaligned_cache():
    q = torch.zeros(1, 16, 8, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 32, 64, dtype=torch.bfloat16)
    _check_kernel_inputs(q, kv, kv)  # 128 rows: two row chunks
    wide = torch.zeros(1, 1, 32, 68, dtype=torch.bfloat16)  # 136-byte rows
    with pytest.raises(ValueError, match="row stride must be a multiple of 16 bytes"):
        _check_kernel_inputs(q, wide[..., :64], wide[..., :64])
    with pytest.raises(ValueError, match="broadcast view"):
        _check_kernel_inputs(q, kv, kv[:, :, :1].expand(1, 1, 32, 64))


def _needed_tiles(n, l_q, window, sinks, keys_per_tile):
    """The key tiles holding a key that some query row attends at valid
    length n, from the mask itself."""
    keys = np.arange(n)
    pos = n - l_q + np.arange(l_q)[:, None]
    keep = keys <= pos
    if window is not None:
        keep &= (keys >= pos - window) | (keys < sinks)
    return set((keys[keep.any(axis=0)] // keys_per_tile).tolist())


def _split_tiles(n, l_q, window, sinks, keys_per_tile, split, n_splits):
    """The tiles that split `split` of n_splits streams, by the loop bounds
    of flash_decode.cu (DecodeTiles)."""
    last = (n - 1) // keys_per_tile
    sink_end = band_begin = 0
    if window is not None:
        band_begin = max(0, n - l_q - window) // keys_per_tile
        sink_end = min(-(-sinks // keys_per_tile), last + 1)
        band_begin = max(band_begin, sink_end)
    order = list(range(sink_end)) + list(range(band_begin, last + 1))
    return order[split * len(order) // n_splits:(split + 1) * len(order) // n_splits]


# (SMs, B·H_kv, L_max, rows, keys per tile, l_q, window, sinks)
PLANS = {
    "serving": (132, 32, 2048, 1, 64, 1, None, 0),
    "bench_l_q8": (132, 32, 600, 8, 64, 8, None, 0),
    "window_sinks": (132, 4, 700, 8, 64, 8, 100, 70),
    "mqa_128_rows": (132, 2, 300, 128, 64, 8, 40, 4),
    "f32_tiles": (132, 8, 333, 4, 32, 4, 17, 2),
    "more_heads_than_sms": (132, 300, 256, 1, 64, 1, None, 0),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_launch_plan_covers_every_needed_tile_once_at_every_length(case):
    sms, n_bhk, l_max, rows, bn, l_q, window, sinks = PLANS[case]
    n_chunks, n_splits = _launch_plan(sms, n_bhk, l_max, rows, bn)
    # The plan has no length in it: one grid serves every n below.
    assert n_chunks == -(-rows // CHUNK_ROWS) <= GRID_YZ_MAX
    assert 1 <= n_splits <= -(-l_max // bn)
    if n_bhk * n_chunks <= sms:
        assert n_splits * n_bhk * n_chunks <= sms  # one wave
    else:
        assert n_splits == 1
    for n in range(l_q, l_max + 1):
        got = [t for split in range(n_splits)
               for t in _split_tiles(n, l_q, window, sinks, bn, split, n_splits)]
        assert len(got) == len(set(got)), n
        assert set(got) == _needed_tiles(n, l_q, window, sinks, bn), n
