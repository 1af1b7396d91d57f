"""The cached CUDA graphs of ``forward``, the train step and ``generate`` on
a card, dense and MoE.

On CUDA tensors each runs as graphs that ``ops.graphs`` caches per key:
captured on the first call (whose eager warm-up is that call's result),
replayed on every later one. Each must give the bits of its eager body
(``capture=False``), count the kernels' launches the eager body would,
capture nothing on a second call with the same key, never rewrite what an
earlier call returned, and hand its memory back on ``clear_graphs()``.
These need the card (the attention kernels have no CPU or interpret mode)
and skip elsewhere. On the card:

    python -m pytest tests/test_torch_graphs_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.models import probe as tprobe
from gpumounter_tpu_torch.ops import graphs
from gpumounter_tpu_torch.ops.launches import launch_counts, reset_launch_counts
from gpumounter_tpu_torch.parallel.train_step import make_train_step, tree_leaves

pytestmark = pytest.mark.gpu

# The configs of test_torch_generate_gpu.py (d_head 32, bf16): dense with
# GQA and a window, and the same width with 4 experts.
CONFIGS = {
    "dense": tprobe.TransformerConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                                      window=24, rope=True, d_ff=256, max_len=96),
    "moe": tprobe.TransformerConfig(n_layers=2, d_model=128, n_heads=4, rope=True,
                                    d_ff=256, max_len=96, n_experts=4),
}
T0, N_NEW, LR = 30, 40, 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels run only there")
    graphs.clear_graphs()
    yield torch.device("cuda")
    graphs.clear_graphs()


def _params(name, device):
    return tprobe.init_params(CONFIGS[name], torch.Generator().manual_seed(0), device)


def _batch(name, device, shape=(3, 64), seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, CONFIGS[name].vocab, shape, generator=gen).to(device)


def _run(fn):
    """fn()'s result and the kernels' launches during it."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def _steps(name, device, capture, n=3):
    """n SGD steps from the seeded params: [(loss, new params)] a step,
    the launches of all of them."""
    step = make_train_step(CONFIGS[name], LR, capture=capture)

    def run():
        params, out = _params(name, device), []
        for i in range(n):
            params, loss = step(params, _batch(name, device, seed=10 + i))
            out.append((loss, params))
        return out

    return _run(run)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_train_steps_equal_the_eager_steps(cuda, name):
    """Three steps: the loss and every leaf bit-equal to capture=False's,
    one capture, the launches the eager steps', and each step's returned
    params unchanged by the later steps."""
    before = graphs.capture.captures
    captured, launches = _steps(name, cuda, None)
    assert graphs.capture.captures - before == 1
    eager, eager_launches = _steps(name, cuda, False)
    assert graphs.capture.captures - before == 1
    assert launches == eager_launches
    assert launches["flash_fwd"] == launches["dq"] == launches["dkv"] == 3 * 2
    for (loss, params), (want_loss, want) in zip(captured, eager):
        assert torch.equal(loss, want_loss)
        for got, exp in zip(tree_leaves(params), tree_leaves(want), strict=True):
            assert torch.equal(got, exp)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_second_step_captures_nothing_and_leaves_earlier_results(cuda, name):
    step = make_train_step(CONFIGS[name], LR)
    params = _params(name, cuda)
    callers = [t.clone() for t in tree_leaves(params)]
    first, loss = step(params, _batch(name, cuda))
    kept = [t.clone() for t in tree_leaves(first)] + [loss.clone()]
    captures = graphs.capture.captures
    second, loss2 = step(first, _batch(name, cuda, seed=2))
    step(second, _batch(name, cuda, seed=3))
    torch.cuda.synchronize()
    assert graphs.capture.captures == captures
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(first) + [loss], kept))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), callers))
    assert not torch.equal(loss, loss2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_forward_equals_the_eager_forward(cuda, name):
    """The logits bit-equal to capture=False's, the first call's and the
    replays'; a second batch of the same shape captures nothing and leaves
    the first logits; a parameter updated in place is read at its new
    value; the launches the eager forward's."""
    cfg, params = CONFIGS[name], _params(name, cuda)
    a, b = _batch(name, cuda), _batch(name, cuda, seed=2)
    before = graphs.capture.captures
    got_a, launches = _run(lambda: tprobe.forward(params, a, cfg))
    want_a, eager_launches = _run(lambda: tprobe.forward(params, a, cfg, capture=False))
    assert launches == eager_launches == {"flash_fwd": 2, "dq": 0, "dkv": 0, "flash_decode": 0}
    kept = got_a.clone()
    got_b, replayed = _run(lambda: tprobe.forward(params, b, cfg))
    assert replayed == launches and graphs.capture.captures - before == 1
    assert torch.equal(got_a, want_a) and torch.equal(got_a, kept)
    assert torch.equal(got_b, tprobe.forward(params, b, cfg, capture=False))
    assert torch.equal(tprobe.forward(params, a, cfg), want_a)
    params["embed"].mul_(1.5)
    assert torch.equal(tprobe.forward(params, a, cfg),
                       tprobe.forward(params, a, cfg, capture=False))
    assert graphs.capture.captures - before == 1


def test_a_new_shape_recaptures_and_evicts(cuda):
    cfg, params = CONFIGS["dense"], _params("dense", cuda)
    before = graphs.capture.captures
    for shape in ((1, 64), (2, 64), (2, 64), (1, 64)):
        tokens = _batch("dense", cuda, shape)
        assert torch.equal(tprobe.forward(params, tokens, cfg),
                           tprobe.forward(params, tokens, cfg, capture=False))
    assert graphs.capture.captures - before == 3
    assert graphs.cached("forward").inputs[0].shape == (1, 64)
    assert torch.equal(tprobe.forward(params, tokens, cfg, capture=True),
                       tprobe.forward(params, tokens, cfg, capture=False))
    assert graphs.capture.captures - before == 3


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [None, 5])
def test_captured_generate_equals_the_eager_loop(cuda, name, seed):
    """Greedy and seeded: each call's tokens bit-equal to capture=False's,
    the generator advanced as far, two captures on the first call and none
    on later ones (a temperature sweep included), the launches the eager
    loop's, and the first call's tokens unchanged by the later calls."""
    cfg, params = CONFIGS[name], _params(name, cuda)

    def gen():
        return None if seed is None else torch.Generator(device=cuda).manual_seed(seed)

    mine, theirs = gen(), gen()
    before, kept = graphs.capture.captures, []
    for i, temperature in enumerate((None, 0.7, 1.3)):
        prompt = _batch(name, cuda, (3, T0), seed=20 + i)
        t = None if seed is None else temperature
        got, launches = _run(lambda: tprobe.generate(params, prompt, cfg, N_NEW, mine, t))
        want, eager_launches = _run(lambda: tprobe.generate_loop(
            params, prompt, cfg, N_NEW, theirs, t, capture=False))
        assert torch.equal(got, want), i
        assert launches == eager_launches
        assert launches["flash_decode"] == cfg.n_layers * (N_NEW - 1)
        if seed is not None:
            assert torch.equal(torch.rand(4, generator=mine, device=cuda),
                               torch.rand(4, generator=theirs, device=cuda))
        assert graphs.capture.captures - before == 2, i
        kept.append((got, got.clone()))
    assert all(torch.equal(a, b) for a, b in kept)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clear_graphs_releases_the_pools(cuda, name):
    """After clear_graphs() the device holds what it held before the
    programs were cached: no graph, pool or static buffer is left. One
    round first, so that what outlives any graph (the kernels' modules,
    each stream's cuBLAS workspace) is in the baseline."""
    cfg, params = CONFIGS[name], _params(name, cuda)
    tokens = _batch(name, cuda, (4, 96))

    def cache_all(rows):
        make_train_step(cfg, LR)(params, tokens[:rows])
        tprobe.forward(params, tokens[:rows], cfg)
        tprobe.generate(params, tokens[:rows, :T0], cfg, N_NEW)
        torch.cuda.synchronize()

    cache_all(4)
    graphs.clear_graphs()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    cache_all(3)
    assert all(graphs.cached(p) is not None for p in ("train_step", "forward", "generate"))
    held = torch.cuda.memory_reserved()
    assert held > reserved
    graphs.clear_graphs()
    assert all(graphs.cached(p) is None for p in ("train_step", "forward", "generate"))
    assert torch.cuda.memory_allocated() == allocated
    assert torch.cuda.memory_reserved() < held
