"""flash_fwd.cu against its plain version on a CUDA card.

These need the card (the kernel has no CPU or interpret mode) and skip
elsewhere. On the card:

    python -m pytest tests/test_torch_flash_kernel_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.models import probe
from gpumounter_tpu_torch.ops.flash_attention import (attention_plain,
                                                      flash_attention_kernel)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: flash_fwd.cu runs only there")
    return torch.device("cuda")


# (b, h, h_kv, l_q, l_k, d, kwargs)
CASES = {
    "causal": (2, 4, 4, 256, 256, 128, dict(causal=True)),
    "gqa_window_sinks": (2, 4, 2, 300, 300, 64, dict(causal=True, window=40, sinks=3)),
    "softcap_lse": (1, 2, 2, 130, 130, 32, dict(causal=True, softcap=5.0, return_lse=True)),
    "decode_offset": (1, 4, 1, 7, 190, 64, dict(causal=True, window=63, return_lse=True)),
    "non_causal_cross": (2, 2, 2, 65, 129, 128, dict(causal=False)),
    # The edges of 128-row q tiles and 128-key k tiles.
    "ragged_129": (1, 2, 2, 129, 129, 128, dict(causal=True, return_lse=True)),
    "ragged_1000": (1, 2, 2, 1000, 1000, 64, dict(causal=True)),
    "cross_1_of_300": (2, 2, 2, 1, 300, 128, dict(causal=True, return_lse=True)),
    "cross_100_of_300": (2, 2, 2, 100, 300, 128, dict(causal=True, return_lse=True)),
    "window_17": (1, 2, 2, 400, 400, 128, dict(causal=True, window=17, return_lse=True)),
    "window_127": (1, 2, 2, 400, 400, 128, dict(causal=True, window=127)),
    "window_128": (1, 2, 2, 400, 400, 128, dict(causal=True, window=128)),
    "window_129": (1, 2, 2, 400, 400, 128, dict(causal=True, window=129)),
    "window_200_sinks_130": (1, 2, 2, 500, 500, 128, dict(causal=True, window=200, sinks=130, return_lse=True)),
    "gqa_group_8": (1, 8, 1, 300, 300, 128, dict(causal=True)),
    "softcap_lse_d128": (1, 2, 2, 300, 300, 128, dict(causal=True, softcap=20.0, return_lse=True)),
    "negative_scale": (1, 2, 2, 200, 200, 64, dict(causal=True, scale=-0.1, return_lse=True)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    b, h, h_kv, l_q, l_k, d, kw = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rand(b, h, l_q, d), rand(b, h_kv, l_k, d), rand(b, h_kv, l_k, d)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = attention_plain(q, k, v, **kw)
    if kw.get("return_lse"):
        (got, got_lse), (want, want_lse) = got, want
        torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-4)
    # bf16: output ulp plus P rounded to bf16 before P·V; f32: sum order.
    tol = dict(atol=2e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_repeated_calls_are_bit_equal(cuda, dtype):
    # No atomics and a fixed order of k tiles: the same inputs give the
    # same bits, lse included.
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 4, 300, 128, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    kw = dict(causal=True, window=129, sinks=3, return_lse=True)
    first = flash_attention_kernel(q, k, v, **kw)
    for _ in range(3):
        again = flash_attention_kernel(q, k, v, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 1, 16, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(q, q, q)


def test_probe_forward_launches_per_layer(cuda):
    cfg = probe.TransformerConfig(n_layers=3)
    params = probe.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda)
    flash_attention_kernel.launches = 0
    logits = probe.forward(params, tokens, cfg)
    assert flash_attention_kernel.launches == cfg.n_layers
    plain = probe.forward(params, tokens, cfg, attention=attention_plain)
    assert (logits - plain).abs().max() <= 2e-2 * plain.abs().max()
