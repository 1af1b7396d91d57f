"""The port's serving path (prefill, decode_step, generate) against the JAX
reference on the CPU.

JAX ``init_params`` weights go through numpy into the port
(``params_from_jax``). Greedy tokens must equal the reference's
``generate`` (its decode kernel in interpret mode, ``attn_backend="xla"``
for the prefill); teacher-forced decode logits must equal the reference's
``forward`` on the same sequence.

On the CPU ``generate`` runs its in-place step body eagerly; the same body
is what a CUDA prompt captures and replays. Here it is held against a
plain loop and run under ``NoHostReads``, and the replay counts are driven
with a stand-in graph; the captured loop itself is tested on the card
(``test_torch_generate_gpu.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpumounter_tpu.models import probe as jprobe
from gpumounter_tpu_torch.models import probe as tprobe
from gpumounter_tpu_torch.ops import graphs
from gpumounter_tpu_torch.ops.flash_attention import flash_attention_kernel
from gpumounter_tpu_torch.ops.flash_decode import flash_decode_kernel
from gpumounter_tpu_torch.weights import params_from_jax

from test_torch_moe import NoHostReads
from test_torch_probe import MOE_FLAGSHIP, jax_routes, port_routes

_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _jax_cfg(cfg: tprobe.TransformerConfig) -> jprobe.TransformerConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["dtype"] = _DTYPES[cfg.dtype]
    return jprobe.TransformerConfig(attn_backend="xla", **fields)


def _both(cfg, seed):
    """(jax params, port params on the CPU) with the same values."""
    jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")


# The reference's generate configs (tests/test_probe_generate.py), f32:
# name: (config, weight seed, prompt shape, n_new)
GREEDY_CASES = {
    "dense_learned_pos": (
        tprobe.TransformerConfig(n_layers=2, d_model=64, n_heads=2, d_ff=128,
                                 max_len=64, dtype=torch.float32),
        0, (2, 5), 10),
    "gqa_window8_rope": (
        tprobe.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, window=8, rope=True, d_ff=128,
                                 max_len=64, dtype=torch.float32),
        3, (2, 6), 10),
    "single_token": (
        tprobe.TransformerConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                                 max_len=32, dtype=torch.float32),
        1, (1, 3), 1),
    "moe4_flagship": (
        tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP),
        2, (2, 6), 12),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_generate_matches_reference(case):
    cfg, seed, shape, n_new = GREEDY_CASES[case]
    jparams, params = _both(cfg, seed)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, shape)
    want = np.asarray(jprobe.generate(jparams, jnp.asarray(prompt, jnp.int32),
                                      _jax_cfg(cfg), n_new))
    got = tprobe.generate(params, torch.from_numpy(prompt), cfg, n_new)
    assert got.shape == (shape[0], shape[1] + n_new)
    np.testing.assert_array_equal(got.numpy(), want)
    # The in-place step loop gives the plain loop's tokens.
    np.testing.assert_array_equal(
        _plain_loop(params, torch.from_numpy(prompt), cfg, n_new).numpy(), want)
    if cfg.n_experts is not None:
        # The generated sequence routes the same on both sides.
        for w, g in zip(jax_routes(jparams, jnp.asarray(want), _jax_cfg(cfg)),
                        port_routes(params, got, cfg), strict=True):
            np.testing.assert_array_equal(g, w)


def _plain_loop(params, prompt, cfg, n_new, generator=None, temperature=1.0):
    """The decode loop written plainly: a list of picked tokens and a new
    length tensor each step, the noise drawn as generate draws it."""

    def pick(logits):
        if generator is None:
            return logits.argmax(dim=-1)
        u = torch.rand(logits.shape, generator=generator)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return (logits / temperature + gumbel).argmax(dim=-1)

    logits, caches = tprobe.prefill(params, prompt, cfg)
    new = [pick(logits)]
    cur_len = torch.tensor(prompt.shape[1], dtype=torch.int32)
    for _ in range(n_new - 1):
        new.append(pick(tprobe.decode_step(params, caches, new[-1], cur_len, cfg)))
        cur_len = cur_len + 1
    return torch.cat([prompt, torch.stack(new, dim=1).to(prompt.dtype)], dim=1)


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_sampled_step_loop_matches_a_plain_loop(case):
    """Seeded sampling through the in-place step body (eagerly, as on the
    CPU) draws the plain loop's noise and picks its tokens."""
    cfg, seed, shape, n_new = GREEDY_CASES[case]
    _, params = _both(cfg, seed)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, shape))
    got = tprobe.generate_loop(params, prompt, cfg, n_new,
                               torch.Generator().manual_seed(seed), 0.7, capture=False)
    want = _plain_loop(params, prompt, cfg, n_new, torch.Generator().manual_seed(seed), 0.7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_new", [1, 2, 3])
def test_few_new_tokens_match_reference(n_new):
    """One new token runs no decode step, two run one eager step and no
    capture on a CUDA prompt, three the first replay."""
    cfg, seed, shape, _ = GREEDY_CASES["dense_learned_pos"]
    jparams, params = _both(cfg, seed)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, shape)
    want = np.asarray(jprobe.generate(jparams, jnp.asarray(prompt, jnp.int32),
                                      _jax_cfg(cfg), n_new))
    got = tprobe.generate_loop(params, torch.from_numpy(prompt), cfg, n_new, capture=False)
    assert got.shape == (shape[0], shape[1] + n_new)
    np.testing.assert_array_equal(got.numpy(), want)


# name: (config, generator seed or None)
STEP_CASES = {
    "gqa_window_greedy": (GREEDY_CASES["gqa_window8_rope"][0], None),
    "gqa_window_sampled": (GREEDY_CASES["gqa_window8_rope"][0], 4),
    "moe4_flagship_greedy": (GREEDY_CASES["moe4_flagship"][0], None),
    "moe4_flagship_sampled": (GREEDY_CASES["moe4_flagship"][0], 4),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_decode_step_body_reads_no_device_value_on_the_host(case):
    """The whole captured step (model step, pick, token write through a
    device index, length increment) stays capturable; two steps write
    columns 1 and 2 of the output, the plain loop's tokens, and leave the
    rest."""
    cfg, seed = STEP_CASES[case]
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1))

    def generator():
        return None if seed is None else torch.Generator().manual_seed(seed)

    temperature = torch.tensor(0.8)
    step, out = tprobe._decoder(params, prompt, cfg, 5, tprobe._picker(generator(), temperature))
    out[:, 3:] = -1
    with torch.no_grad(), NoHostReads():
        step()
        step()
    want = _plain_loop(params, prompt, cfg, 3, generator(), temperature)[:, 9:]
    torch.testing.assert_close(out[:, :3], want, rtol=0, atol=0)
    assert out[:, 3:].eq(-1).all()


def test_capture_needs_a_cuda_prompt():
    cfg, params, prompt = _sampling_setup()
    with pytest.raises(ValueError, match="capture needs a CUDA prompt"):
        tprobe.generate_loop(params, prompt, cfg, 4, capture=True)


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("k", [1, 5])
def test_counted_replay_adds_the_per_step_counts_per_replay(monkeypatch, k):
    """A capture counts but runs nothing; each replay runs what it holds.
    After a capture and k replays the counts are k x a step's, not k + 1."""
    counters = graphs.COUNTERS
    for fn, name in counters:
        monkeypatch.setattr(fn, name, 7)
    per_step = {(flash_decode_kernel, "launches"): 3,
                (flash_attention_kernel, "launches"): 1}

    def record():  # what the wrappers count while a step is captured
        for (fn, name), n in per_step.items():
            setattr(fn, name, getattr(fn, name) + n)

    graph = _StandInGraph()
    replay = graphs.counted_replay(graph, record)
    assert [getattr(fn, name) for fn, name in counters] == [7] * len(counters)
    for _ in range(k):
        replay()
    assert graph.replays == k
    for fn, name in counters:
        assert getattr(fn, name) == 7 + k * per_step.get((fn, name), 0), name


def _teacher_forced(params, tokens, t0, cfg):
    """Logits (B, T - t0 + 1, V) at positions t0 - 1 .. T - 1: the
    prefill's, then one decode_step per further token of `tokens`."""
    logits, caches = tprobe.prefill(params, tokens[:, :t0], cfg)
    out = [logits]
    cur_len = torch.tensor(t0, dtype=torch.int32)
    for p in range(t0, tokens.shape[1]):
        out.append(tprobe.decode_step(params, caches, tokens[:, p], cur_len,
                                      cfg))
        cur_len = cur_len + 1
    return torch.stack(out, dim=1)


# name: (config, atol on logits). f32: summation order only. bf16: the two
# frameworks round activations at different places, and the decode path's
# one-row matmuls round differently from the forward's: a few bf16 ulps at
# the logits' scale (~0.02, 1 ulp 1.2e-4).
TEACHER_CASES = {
    "dense_learned_pos_f32": (
        tprobe.TransformerConfig(n_layers=2, d_model=64, n_heads=2, d_ff=128,
                                 max_len=32, dtype=torch.float32), 1e-5),
    "mqa_window5_rope_f32": (
        tprobe.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=1, window=5, rope=True, d_ff=128,
                                 max_len=32, dtype=torch.float32), 1e-5),
    "gqa_rope_bf16": (
        tprobe.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, rope=True, d_ff=128,
                                 max_len=32, dtype=torch.bfloat16), 1e-3),
    "moe4_flagship_f32": (
        tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP), 1e-5),
}


@pytest.mark.parametrize("case", list(TEACHER_CASES))
def test_teacher_forced_decode_matches_reference_forward(case):
    cfg, atol = TEACHER_CASES[case]
    jparams, params = _both(cfg, seed=11)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 20))
    want = np.asarray(jprobe.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                     _jax_cfg(cfg)))
    t0 = 7
    got = _teacher_forced(params, torch.from_numpy(tokens), t0, cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:, t0 - 1:], atol=atol,
                               rtol=0)


def _sampling_setup():
    cfg = tprobe.TransformerConfig(n_layers=1, d_model=64, n_heads=2,
                                   d_ff=128, max_len=64, dtype=torch.float32)
    return cfg, tprobe.init_params(cfg, torch.Generator().manual_seed(7),
                                   "cpu"), torch.tensor([[1, 2, 3]])


def test_sampled_generate_is_reproducible_per_seed():
    cfg, params, prompt = _sampling_setup()

    def sample(seed, temperature=1.0):
        return tprobe.generate(params, prompt, cfg, 12,
                               torch.Generator().manual_seed(seed),
                               temperature)

    a, b, c = sample(1), sample(1), sample(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.shape == (1, 15) and a.min() >= 0 and a.max() < cfg.vocab
    assert torch.equal(a[:, :3], prompt)
    # Without a generator the path is exactly greedy.
    greedy = tprobe.generate(params, prompt, cfg, 12)
    logits = tprobe.forward(params, greedy[:, :-1], cfg)
    assert torch.equal(greedy[:, 3:], logits[:, 2:].argmax(-1))
    # A tensor temperature of 0 is floored to 1e-6, which is greedy.
    torch.testing.assert_close(sample(3, torch.tensor(0.0)), greedy,
                               rtol=0, atol=0)


def test_zero_new_tokens_returns_the_prompt():
    cfg, params, prompt = _sampling_setup()
    assert tprobe.generate(params, prompt, cfg, 0) is prompt


# name: (prompt length, n_new, generator seed or None, temperature, match)
GENERATE_ERRORS = {
    "negative_n_new": (3, -1, None, None, "n_new must be >= 0"),
    "overflow": (60, 10, None, None, "exceeds max_len"),
    "temperature_without_generator": (3, 4, None, 1.0,
                                      "temperature without a generator"),
    "nan_temperature": (3, 4, 0, float("nan"), "must be > 0"),
    "zero_temperature": (3, 4, 0, 0.0, "must be > 0"),
}


@pytest.mark.parametrize("case", list(GENERATE_ERRORS))
def test_generate_refuses_bad_arguments(case):
    t0, n_new, seed, temperature, match = GENERATE_ERRORS[case]
    cfg, params, _ = _sampling_setup()
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with pytest.raises(ValueError, match=match):
        tprobe.generate(params, torch.zeros((1, t0), dtype=torch.long), cfg,
                        n_new, gen, temperature)


def test_decode_step_never_reads_a_device_value_on_the_host(monkeypatch):
    """The step must be capturable as one CUDA graph: no .item(), and the
    length only ever a tensor. Pinned by making Tensor.item raise."""
    cfg = tprobe.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                   n_kv_heads=2, window=6, d_ff=128,
                                   max_len=32, dtype=torch.float32)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    _, caches = tprobe.prefill(params, prompt, cfg)
    before = [kc.clone() for kc, _ in caches]

    def no_item(self):
        raise AssertionError("Tensor.item() called inside decode_step")

    monkeypatch.setattr(torch.Tensor, "item", no_item)
    launches = flash_decode_kernel.launches
    with torch.autograd.grad_mode.no_grad():
        logits = tprobe.decode_step(params, caches, prompt[:, -1],
                                    torch.tensor(9, dtype=torch.int32), cfg)
    monkeypatch.undo()
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    assert flash_decode_kernel.launches == launches  # CPU: the plain version
    for (kc, _), old in zip(caches, before):
        # slot 9 written in place, every other slot untouched
        assert not torch.equal(kc[:, :, 9], old[:, :, 9])
        torch.testing.assert_close(kc[:, :, :9], old[:, :, :9], rtol=0, atol=0)
        torch.testing.assert_close(kc[:, :, 10:], old[:, :, 10:], rtol=0,
                                   atol=0)


def test_moe_decode_step_never_reads_a_device_value_on_the_host():
    """An MoE decode step stays capturable: no .item(), nonzero or
    boolean-mask indexing anywhere in it (the routing included)."""
    cfg = tprobe.TransformerConfig(dtype=torch.bfloat16, **MOE_FLAGSHIP)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    _, caches = tprobe.prefill(params, prompt, cfg)
    with torch.no_grad(), NoHostReads():
        logits = tprobe.decode_step(params, caches, prompt[:, -1],
                                    torch.tensor(9, dtype=torch.int32), cfg)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()


def test_prefill_caches_hold_the_prompt_keys_zero_filled():
    cfg = tprobe.TransformerConfig(n_layers=1, d_model=64, n_heads=4,
                                   n_kv_heads=2, rope=True, d_ff=128,
                                   max_len=16, dtype=torch.float32)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    prompt = torch.tensor([[5, 6, 7, 8, 9]])
    logits, [(kc, vc)] = tprobe.prefill(params, prompt, cfg)
    assert kc.shape == vc.shape == (1, cfg.kv_heads, cfg.max_len, cfg.d_head)
    assert not kc[:, :, :5].eq(0).all() and kc[:, :, 5:].eq(0).all()
    assert vc[:, :, 5:].eq(0).all()
    torch.testing.assert_close(logits, tprobe.forward(params, prompt, cfg)[:, -1],
                               rtol=1e-6, atol=1e-6)
