"""flash_bwd.cu against its plain version on a CUDA card.

These need the card (the kernels have no CPU or interpret mode) and skip
elsewhere. On the card:

    python -m pytest tests/test_torch_flash_backward_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.ops.flash_attention import (
    attention_bwd_plain, flash_attention, flash_attention_bwd_kernel,
    flash_attention_kernel)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: flash_bwd.cu runs only there")
    return torch.device("cuda")


# (b, h, h_kv, l_q, l_k, d, kwargs, with dlse)
CASES = {
    "causal": (2, 4, 4, 256, 256, 128, dict(causal=True), False),
    "gqa_window_sinks_softcap": (2, 4, 2, 300, 300, 64,
                                 dict(causal=True, window=40, sinks=3, softcap=5.0), False),
    "decode_offset_dlse": (1, 4, 1, 70, 190, 32, dict(causal=True, window=63), True),
}
# Share of each gradient's max |value|. bf16: one rounding of the output
# and of p and ds before their products (as the TPU kernel does), where the
# plain version keeps f32; f32: the order of summation only.
RTOL_OF_MAX = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _inputs(case, dtype, device):
    b, h, h_kv, l_q, l_k, d, kw, with_dlse = CASES[case]
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    q, k, v = rand(b, h, l_q, d), rand(b, h_kv, l_k, d), rand(b, h_kv, l_k, d)
    o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    dlse = rand(b, h, l_q, dt=torch.float32) if with_dlse else None
    return (q, k, v, o, lse, rand(b, h, l_q, d), dlse), kw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_and_repeat_bit_for_bit(cuda, case, dtype):
    args, kw = _inputs(case, dtype, cuda)
    before = (flash_attention_bwd_kernel.dq_launches,
              flash_attention_bwd_kernel.dkv_launches)
    got = flash_attention_bwd_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_kernel.dq_launches,
            flash_attention_bwd_kernel.dkv_launches) == (before[0] + 1, before[1] + 1)
    # No atomics and a fixed order of the group sum: the same bits again.
    again = flash_attention_bwd_kernel(*args, **kw)
    want = attention_bwd_plain(*args, **kw)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, a), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= RTOL_OF_MAX[dtype] * w.float().abs().max().item(), (name, err)


def test_autograd_through_the_public_entry_launches_both_kernels(cuda):
    (q, k, v, _, _, do, _), _ = _inputs("causal", torch.bfloat16, cuda)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = flash_attention_bwd_kernel.dq_launches
    torch.autograd.backward(flash_attention(q, k, v), do)
    assert flash_attention_bwd_kernel.dq_launches == before + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_head_dim_4_raises(cuda):
    """The reference's flagship head dim: no kernel of the port takes it."""
    q = torch.zeros(1, 2, 16, 4, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd_kernel(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q.requires_grad_(), q, q)
