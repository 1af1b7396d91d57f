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


def _bf16_tol(want):
    """4 bf16 ulps (2^-8) of the output's max |value|, at most 2e-2: a
    decode output averages many keys, so |o| may be far below 2e-2."""
    return dict(atol=min(2e-2, 4 * 2**-8 * want.float().abs().max().item()), rtol=1e-2)


# (b, h, h_kv, l_q, l_max, d, cache_len, kwargs)
CASES = {
    "serving_row": (2, 8, 8, 1, 512, 128, 300, {}),
    "gqa_l_q4_window_sinks": (2, 8, 2, 4, 700, 64, 650, dict(window=100, sinks=5)),
    "mqa_64_rows": (1, 8, 1, 8, 200, 32, 199, {}),
    # Beyond one block's 64 rows: two row chunks, each reading the cache.
    "mqa_128_rows_window_sinks": (1, 16, 1, 8, 300, 128, 257, dict(window=100, sinks=4)),
    "gqa_72_rows_d64": (2, 18, 2, 8, 400, 64, 131, {}),
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
    # f32: sum order. bf16: output ulp plus P rounded to bf16 before P·V.
    tol = _bf16_tol(want) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
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


def test_nan_past_the_length_never_enters_bf16(cuda):
    # A length inside a 64-key tile: TMA brings the tile's NaN slots in,
    # and the kernel must keep them out of both products.
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for shape in ((2, 8, 1, 128), (2, 8, 2048, 128), (2, 8, 2048, 128)))
    k[:, :, 1001:] = float("nan")
    v[:, :, 1001:] = float("nan")
    got = flash_decode_kernel(q, k, v, 1001)
    want = flash_decode_plain(q, k[:, :, :1001], v[:, :, :1001], 1001)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **_bf16_tol(want))


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 1, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_kernel(q, q, q, 1)
    q = torch.zeros(1, 16, 8, 64, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 32, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cache_len"):
        flash_decode_kernel(q[:, :8], kv, kv, torch.tensor([8]))  # on the CPU
    wide = torch.zeros(1, 1, 32, 68, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row stride"):  # 136-byte rows
        flash_decode_kernel(q, wide[..., :64], wide[..., :64], 8)


def _capture(fn):
    """A CUDA graph of fn() and its output, after an eager call on a side
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("h,l_q", [(8, 1), (16, 8)], ids=["8_rows", "128_rows"])
def test_graph_replays_at_three_lengths_equal_eager_calls(cuda, h, l_q):
    gen = torch.Generator(device=cuda).manual_seed(2)
    l_max = 2048
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
               for shape in ((2, h, l_q, 128), (2, 1, l_max, 128), (2, 1, l_max, 128)))
    length = torch.tensor([l_max], dtype=torch.int32, device=cuda)
    graph, out = _capture(lambda: flash_decode_kernel(q, k, v, length, window=300, sinks=4))
    for n in (1, 1001, l_max):
        length.fill_(n)
        graph.replay()
        eager = flash_decode_kernel(q, k, v, n, window=300, sinks=4)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), n


def test_calls_overlapping_on_two_streams_equal_calls_on_one(cuda):
    # Calls of one shape have as many merge tickets; held back behind a
    # sleeping kernel, they start together on two streams and must not
    # share them. One split (B·H_kv fills the card), many splits, and two
    # row chunks.
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for b, h, h_kv, l_q in ((66, 8, 8, 1), (1, 8, 8, 1), (2, 16, 1, 8)):
        gen = torch.Generator(device=cuda).manual_seed(3)
        calls = [[torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
                  for shape in ((b, h, l_q, 64), (b, h_kv, 4096, 64), (b, h_kv, 4096, 64))]
                 for _ in range(8)]
        want = [flash_decode_kernel(*x, 4000) for x in calls]
        torch.cuda._sleep(50_000_000)
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        got = []
        for i, x in enumerate(calls):
            with torch.cuda.stream(streams[i % 2]):
                got.append(flash_decode_kernel(*x, 4000))
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (b, h, h_kv, l_q, i)


def test_generate_launches_per_layer_and_step(cuda):
    cfg = probe.TransformerConfig(n_layers=3, max_len=64)
    params = probe.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 20), device=cuda)
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    out = probe.generate(params, prompt, cfg, 9)
    assert out.shape == (2, 29)
    assert flash_attention_kernel.launches == cfg.n_layers
    assert flash_decode_kernel.launches == cfg.n_layers * 8
