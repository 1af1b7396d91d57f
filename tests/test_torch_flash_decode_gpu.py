"""flash_decode.cu against its plain version on a CUDA card.

These need the card (the kernel has no CPU or interpret mode) and skip
elsewhere. On the card:

    python -m pytest tests/test_torch_flash_decode_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.models import probe
from gpumounter_tpu_torch.ops.flash_attention import flash_attention_kernel
from gpumounter_tpu_torch.ops.flash_decode import (flash_decode_kernel,
                                                   flash_decode_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: flash_decode.cu runs only there")
    return torch.device("cuda")


# (b, h, h_kv, l_q, l_max, d, cache_len, kwargs)
CASES = {
    "serving_row": (2, 8, 8, 1, 512, 128, 300, {}),
    "gqa_l_q4_window_sinks": (2, 8, 2, 4, 700, 64, 650, dict(window=100, sinks=5)),
    "mqa_64_rows": (1, 8, 1, 8, 200, 32, 199, {}),
    "clipped_above": (1, 2, 2, 3, 96, 128, 5000, {}),
    "clipped_below": (1, 2, 2, 3, 96, 128, 1, {}),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    b, h, h_kv, l_q, l_max, d, n, kw = CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rand(b, h, l_q, d), rand(b, h_kv, l_max, d), rand(b, h_kv, l_max, d)
    before = flash_decode_kernel.launches
    got = flash_decode_kernel(q, k, v, n, **kw)
    torch.cuda.synchronize()
    assert flash_decode_kernel.launches == before + 1
    by_tensor = flash_decode_kernel(
        q, k, v, torch.tensor([n], dtype=torch.int32, device=cuda), **kw)
    torch.testing.assert_close(by_tensor, got, rtol=0, atol=0)
    want = flash_decode_plain(q, k, v, n, **kw)
    # bf16: output ulp plus P rounded to bf16 before P·V; f32: sum order.
    tol = dict(atol=2e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, want, **tol)


def test_nan_past_the_length_never_enters(cuda):
    q = torch.randn(1, 4, 1, 64, device=cuda)
    k = torch.randn(1, 4, 256, 64, device=cuda)
    v = torch.randn(1, 4, 256, 64, device=cuda)
    k[:, :, 100:] = float("nan")
    v[:, :, 100:] = float("nan")
    got = flash_decode_kernel(q, k, v, 100)
    want = flash_decode_plain(q, k[:, :, :100], v[:, :, :100], 100)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 1, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_kernel(q, q, q, 1)
    q = torch.zeros(1, 16, 8, 64, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 32, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="query rows"):
        flash_decode_kernel(q, kv, kv, 8)
    with pytest.raises(ValueError, match="cache_len"):
        flash_decode_kernel(q[:, :8], kv, kv, torch.tensor([8]))  # on the CPU


def test_generate_launches_per_layer_and_step(cuda):
    cfg = probe.TransformerConfig(n_layers=3, max_len=64)
    params = probe.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 20), device=cuda)
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    out = probe.generate(params, prompt, cfg, 9)
    assert out.shape == (2, 29)
    assert flash_attention_kernel.launches == cfg.n_layers
    assert flash_decode_kernel.launches == cfg.n_layers * 8
