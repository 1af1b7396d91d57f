"""The MoE probe on a CUDA card: ``moe_ffn`` against ``moe_ffn_plain``, the
MoE flagship's grads through the kernels against the plain attention's,
and a captured MoE decode step.

These need the card (the attention kernels have no CPU or interpret
mode) and skip elsewhere. On the card:

    python -m pytest tests/test_torch_moe_gpu.py -q -m gpu
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpumounter_tpu_torch.entry import TRAIN_GRAD_ATOL, moe_blocks_vs_plain, moe_check
from gpumounter_tpu_torch.models import probe as tprobe
from gpumounter_tpu_torch.ops.flash_decode import flash_decode_kernel
from gpumounter_tpu_torch.parallel import moe as tmoe

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MoE probe's attention kernels run only there")
    return torch.device("cuda")


# moe_ffn's batched products over every token against the loop's products
# over each expert's own tokens: cuBLAS may sum in another order for the two
# shapes. bf16: the expert products round to bf16 in both, so the outputs
# may differ by a few ulps, held to 4 bf16 ulps (2^-8 each) of the output's
# max |value|; f32 (no TF32, torch's default): the order of summation, 1e-5 of the max.
OUT_OF_MAX = {torch.bfloat16: 4 * 2**-8, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_moe_ffn_matches_plain(cuda, dtype):
    params = tmoe.init_moe_params(torch.Generator().manual_seed(0), 8, 512, 1024, dtype, cuda)
    x = torch.randn((2048, 512), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(dtype)
    out, aux = tmoe.moe_ffn(params, x)
    want, want_aux, want_idx = tmoe.moe_ffn_plain(params, x)
    idx, _ = tmoe._route(params, x)
    assert torch.equal(idx, want_idx)
    assert torch.unique(idx).numel() == 8
    assert abs(aux.item() - want_aux.item()) <= 1e-5
    limit = OUT_OF_MAX[dtype] * want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= limit


def test_moe_check(cuda):
    result = moe_check()
    assert 0 <= result["max_grad_err"] < TRAIN_GRAD_ATOL
    assert np.isfinite(result["moe_step_losses"]).all()


# The MoE flagship's dialect (GQA, window, RoPE) at d_head 64 and a longer
# sequence than moe_check's. Grads of each block leaf and of the block's
# input through the kernels against the plain attention's, the flipped
# tokens left out (entry.moe_blocks_vs_plain): within 5% of each plain
# grad's max |value|, as chip_smoke.py's training check.
GRAD_RTOL_OF_MAX = 5e-2


def test_moe_flagship_grads_block_by_block(cuda):
    cfg = tprobe.TransformerConfig(n_layers=2, d_model=512, n_heads=8, d_ff=256,
                                   max_len=512, n_kv_heads=4, window=100, rope=True,
                                   n_experts=8)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(2), cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 512))).to(cuda)
    records = moe_blocks_vs_plain(params, tokens, cfg, grads=True)
    for i, record in enumerate(records):
        assert record["out_err"] <= 2e-2 * record["out_max"], i
        for name, (err, peak) in record["grads"].items():
            assert err <= GRAD_RTOL_OF_MAX * peak, (i, name, err, peak)


def test_captured_moe_decode_step_replays_equal_to_eager(cuda):
    cfg = tprobe.TransformerConfig(n_layers=2, d_model=256, n_heads=2, d_ff=512,
                                   max_len=256, rope=True, n_experts=4)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(3), cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 256))).to(cuda)
    _, caches = tprobe.prefill(params, tokens[:, :200], cfg)
    token = tokens[:, 40].clone()
    cur_len = torch.full((), 40, dtype=torch.int32, device=cuda)

    def step():
        return tprobe.decode_step(params, caches, token, cur_len, cfg)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits = step()
    for n in (40, 199):
        token.copy_(tokens[:, n])
        cur_len.fill_(n)
        launches = flash_decode_kernel.launches
        graph.replay()
        torch.cuda.synchronize()
        assert flash_decode_kernel.launches == launches  # no wrapper ran
        replayed = logits.clone()
        eager = tprobe.decode_step(params, caches, tokens[:, n],
                                   torch.full((), n, dtype=torch.int32, device=cuda), cfg)
        assert torch.equal(replayed, eager), n
