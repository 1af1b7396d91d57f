"""The captured ``generate`` loop on a CUDA card, dense and MoE.

On a CUDA prompt ``generate`` runs the first decode step eagerly and
replays one captured step for the rest; ``generate_loop(capture=False)``
runs every step eagerly. The two must give the same bits, greedy and
seeded, and the kernels' launch counts must follow the replays. These
need the card (the attention kernels have no CPU or interpret mode) and
skip elsewhere. On the card:

    python -m pytest tests/test_torch_generate_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.models import probe as tprobe
from gpumounter_tpu_torch.ops.flash_attention import flash_attention_kernel
from gpumounter_tpu_torch.ops.flash_decode import flash_decode_kernel

pytestmark = pytest.mark.gpu

# Small configs the kernels take (d_head 32, bf16): dense with GQA and a
# window, and the same with 4 experts.
CONFIGS = {
    "dense": tprobe.TransformerConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                                      window=24, rope=True, d_ff=256, max_len=96),
    "moe": tprobe.TransformerConfig(n_layers=2, d_model=128, n_heads=4, rope=True,
                                    d_ff=256, max_len=96, n_experts=4),
}
T0, N_NEW = 30, 40


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels run only there")
    return torch.device("cuda")


def _setup(name, device):
    cfg = CONFIGS[name]
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), device)
    prompt = torch.randint(0, cfg.vocab, (3, T0), generator=torch.Generator().manual_seed(1))
    return cfg, params, prompt.to(device)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_greedy_tokens_equal_the_eager_loop(cuda, name):
    cfg, params, prompt = _setup(name, cuda)
    captured = tprobe.generate(params, prompt, cfg, N_NEW)
    eager = tprobe.generate_loop(params, prompt, cfg, N_NEW, capture=False)
    assert captured.shape == (3, T0 + N_NEW)
    assert torch.equal(captured, eager)
    assert torch.equal(captured, tprobe.generate_loop(params, prompt, cfg, N_NEW, capture=True))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_sampling_follows_the_generator(cuda, name):
    """A CUDA generator registered with the graph advances on every replay:
    one seed gives the eager loop's tokens, two seeds differ."""
    cfg, params, prompt = _setup(name, cuda)

    def sample(seed, capture):
        """The tokens, and the generator's next draw after the call."""
        gen = torch.Generator(device=cuda).manual_seed(seed)
        tokens = tprobe.generate_loop(params, prompt, cfg, N_NEW, gen, 1.0, capture=capture)
        return tokens, torch.rand(4, generator=gen, device=cuda)

    (a, after), (eager, eager_after) = sample(5, True), sample(5, False)
    assert torch.equal(a, eager)
    assert torch.equal(after, eager_after)  # advanced as far as the eager loop
    assert torch.equal(a, sample(5, True)[0])
    assert not torch.equal(a, sample(6, True)[0])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("n_new", [1, 2, 3, N_NEW])
def test_launch_counts_follow_the_replays(cuda, name, n_new):
    cfg, params, prompt = _setup(name, cuda)
    flash_attention_kernel.launches = flash_decode_kernel.launches = 0
    out = tprobe.generate(params, prompt, cfg, n_new)
    torch.cuda.synchronize()
    assert out.shape == (3, T0 + n_new)
    assert flash_attention_kernel.launches == cfg.n_layers
    assert flash_decode_kernel.launches == cfg.n_layers * (n_new - 1)
    assert torch.equal(out, tprobe.generate_loop(params, prompt, cfg, n_new, capture=False))


def test_cpu_generator_with_a_cuda_prompt_is_refused(cuda):
    cfg, params, prompt = _setup("dense", cuda)
    with pytest.raises(ValueError, match="cpu"):
        tprobe.generate(params, prompt, cfg, 4, torch.Generator().manual_seed(0), 1.0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_repeated_calls_hold_no_memory(cuda, name):
    """Each call's graph and its private pool go with the call."""
    cfg, params, prompt = _setup(name, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    first = tprobe.generate(params, prompt, cfg, N_NEW, gen, 1.0)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    for _ in range(2):
        tprobe.generate(params, prompt, cfg, N_NEW, gen, 1.0)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated
    assert first.shape == (3, T0 + N_NEW)
