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
    # The edges of the bf16 kernels' tiles: blocks of 128 queries (dq) and
    # of 64 keys (dk/dv), tiles of 64 rows streamed against them.
    "ragged_1000": (1, 2, 2, 1000, 1000, 64, dict(causal=True), False),
    "ragged_300": (2, 2, 2, 300, 300, 128, dict(causal=True), False),
    "cross_100_of_300_dlse": (2, 2, 2, 100, 300, 128, dict(causal=True), True),
    "cross_1_of_300": (2, 2, 2, 1, 300, 128, dict(causal=True), False),
    "non_causal_cross": (2, 2, 2, 65, 129, 128, dict(causal=False), False),
    "window_17": (1, 2, 2, 400, 400, 128, dict(causal=True, window=17), False),
    "window_127": (1, 2, 2, 400, 400, 128, dict(causal=True, window=127), False),
    "window_128": (1, 2, 2, 400, 400, 128, dict(causal=True, window=128), False),
    "window_129": (1, 2, 2, 400, 400, 128, dict(causal=True, window=129), False),
    "window_200_sinks_130": (1, 2, 2, 500, 500, 128, dict(causal=True, window=200, sinks=130), False),
    "window_50_sinks_70_d64": (1, 2, 2, 400, 400, 64, dict(causal=True, window=50, sinks=70), False),
    "gqa_group_4": (1, 8, 2, 300, 300, 128, dict(causal=True), False),
    "gqa_group_8": (1, 8, 1, 300, 300, 128, dict(causal=True), False),
    "d32": (2, 2, 2, 200, 200, 32, dict(causal=True), False),
    "softcap_d128": (1, 2, 2, 300, 300, 128, dict(causal=True, softcap=20.0), False),
    "negative_scale": (1, 2, 2, 200, 200, 64, dict(causal=True, scale=-0.1), False),
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


@pytest.mark.parametrize("form", ["expanded_w", "sum"])
def test_broadcast_output_gradient(cuda, form):
    """A broadcast gradient of o (w (L, D) handed in as w.expand_as(o), or
    the all-zero strides of o.sum()'s) cannot be read by a TMA tensor map:
    the wrapper copies it, and the grads match the plain backward."""
    (q, k, v, o, lse, do, _), kw = _inputs("causal", torch.bfloat16, cuda)
    do = do[0, 0] if form == "expanded_w" else torch.ones((), dtype=do.dtype, device=cuda)
    do = do.expand_as(o)
    assert do.stride(0) == 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    before = flash_attention_bwd_kernel.dq_launches
    if form == "sum":
        got = torch.autograd.grad(out.sum(), leaves)
    else:
        got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd_kernel.dq_launches == before + 1
    want = attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= RTOL_OF_MAX[torch.bfloat16] * w.float().abs().max().item(), (name, err)


def test_head_dim_4_raises(cuda):
    """The reference's flagship head dim: no kernel of the port takes it."""
    q = torch.zeros(1, 2, 16, 4, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd_kernel(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q.requires_grad_(), q, q)
