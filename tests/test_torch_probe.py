"""The port's probe forward against the JAX reference on the CPU.

JAX ``init_params`` weights go through numpy into the port
(``params_from_jax``); both forwards run on the same numpy tokens. The
reference runs with ``attn_backend="xla"``, its CPU path.
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
from gpumounter_tpu_torch.entry import entry
from gpumounter_tpu_torch.ops.flash_attention import flash_attention
from gpumounter_tpu_torch.parallel.moe import _route
from gpumounter_tpu_torch.weights import params_from_jax

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


def _both(cfg, seed=0):
    """(jax params, port params on the CPU) with the same values."""
    jparams = jprobe.init_params(_jax_cfg(cfg), jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_jax(tree, cfg, "cpu")


SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=16)
# The reference's MoE probe tests' config (tests/test_probe_moe.py): the
# dryrun flagship's dialect (d_head 4) with 4 experts.
MOE_FLAGSHIP = dict(n_layers=2, d_model=64, n_heads=16, d_ff=128, max_len=32,
                    n_kv_heads=8, window=8, rope=True, n_experts=4)
# (config, atol on logits). f32: only summation order differs. bf16: the
# two frameworks round activations at different places (1 bf16 ulp at the
# logits' scale of ~0.02 is 1.2e-4).
FORWARD_CASES = {
    "dense_mha_learned_pos_f32": (
        tprobe.TransformerConfig(dtype=torch.float32, **SMALL), 1e-6),
    "gqa_window_rope_f32": (
        tprobe.TransformerConfig(dtype=torch.float32, n_kv_heads=2, window=4,
                                 rope=True, **SMALL), 1e-6),
    "dense_mha_bf16": (
        tprobe.TransformerConfig(dtype=torch.bfloat16, **SMALL), 5e-4),
    "moe4_flagship_f32": (
        tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP), 1e-6),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_reference(case):
    cfg, atol = FORWARD_CASES[case]
    jparams, params = _both(cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    want = np.asarray(jprobe.forward(jparams, jnp.asarray(tokens, jnp.int32),
                                     _jax_cfg(cfg)))
    got = tprobe.forward(params, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    # next_token_nll on the same logits
    nll_want = float(jprobe.next_token_nll(jnp.asarray(want),
                                           jnp.asarray(tokens, jnp.int32)))
    nll_got = tprobe.next_token_nll(torch.from_numpy(want.copy()),
                                    torch.from_numpy(tokens)).item()
    assert nll_got == pytest.approx(nll_want, abs=1e-6)


def jax_routes(jparams, tokens, jcfg) -> list[np.ndarray]:
    """The reference's expert index per token (b·t,) at each MoE layer,
    from its own block functions."""
    b, t = tokens.shape
    x = jparams["embed"][tokens]
    if not jcfg.rope:
        x = x + jparams["pos"][:t]
    routes = []
    for blk in jparams["blocks"]:
        q, k, v = jprobe._qkv_heads(x, blk, jcfg)
        q, k = jprobe._maybe_rope(q, k, jcfg, jnp.arange(t, dtype=jnp.int32))
        heads = jprobe._attention(q, k, v, jcfg)
        xa = x + heads.transpose(0, 2, 1, 3).reshape(b, t, -1) @ blk["wo"]
        h = jprobe._rmsnorm(xa, blk["ln2"]).reshape(b * t, -1)
        probs = jax.nn.softmax(h.astype(jnp.float32) @ blk["router"], axis=-1)
        routes.append(np.asarray(jnp.argmax(probs, axis=-1)))
        x, _ = jprobe._block(x, blk, jcfg)
    return routes


def port_routes(params, tokens, cfg) -> list[np.ndarray]:
    """The port's expert index per token at each MoE layer (``_route``,
    which ``moe_ffn`` uses)."""
    x, routes = tprobe._embed(params, tokens, cfg), []
    for blk in params["blocks"]:
        xa = tprobe._attend(x, blk, cfg, flash_attention)[0]
        routes.append(_route(blk, tprobe._rmsnorm(xa, blk["ln2"]).flatten(0, 1))[0].numpy())
        x, _ = tprobe._finish_block(xa, blk)
    return routes


def test_moe_forward_routes_as_reference():
    """Every token of every layer goes to the same expert on both sides,
    and every expert gets tokens somewhere."""
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **MOE_FLAGSHIP)
    jparams, params = _both(cfg, seed=4)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    want = jax_routes(jparams, jnp.asarray(tokens, jnp.int32), _jax_cfg(cfg))
    got = port_routes(params, torch.from_numpy(tokens), cfg)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g, w)
    assert set(np.concatenate(got).tolist()) == set(range(cfg.n_experts))


def test_forward_refuses_too_long_sequence():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **SMALL)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        tprobe.forward(params, torch.zeros((1, 17), dtype=torch.long), cfg)


def test_params_from_jax_is_bit_exact_on_bf16():
    cfg = tprobe.TransformerConfig(dtype=torch.bfloat16, **SMALL)
    jparams, params = _both(cfg, seed=3)
    pairs = [(jparams["embed"], params["embed"]),
             (jparams["pos"], params["pos"])]
    for jb, tb in zip(jparams["blocks"], params["blocks"]):
        pairs += [(jb[key], tb[key]) for key in jb]
    for jw, tw in pairs:
        assert tw.dtype == torch.bfloat16
        want_bits = np.asarray(jw).view(np.uint16)
        got_bits = tw.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got_bits, want_bits)


def test_params_from_jax_checks_layout():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, **SMALL)
    tree = jax.tree.map(np.asarray,
                        jprobe.init_params(_jax_cfg(cfg), jax.random.key(0)))
    with pytest.raises(ValueError, match="position table"):
        params_from_jax(tree, dataclasses.replace(cfg, rope=True), "cpu")
    with pytest.raises(ValueError, match="config says"):
        params_from_jax(tree, dataclasses.replace(cfg, dtype=torch.bfloat16),
                        "cpu")


def test_params_from_jax_is_bit_exact_on_moe_bf16():
    """An MoE block carries across bit for bit: the router in float32, the
    stacked experts and the rest in bf16."""
    cfg = tprobe.TransformerConfig(dtype=torch.bfloat16, **MOE_FLAGSHIP)
    jparams, params = _both(cfg, seed=5)
    for jb, tb in zip(jparams["blocks"], params["blocks"], strict=True):
        assert set(tb) == set(jb) == {"wqkv", "wo", "ln1", "ln2", "router", "w1", "w2"}
        for key, jw in jb.items():
            tw = tb[key]
            assert tuple(tw.shape) == jw.shape, key
            if key == "router":
                assert tw.dtype == torch.float32
                np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                              np.asarray(jw).view(np.uint32))
            else:
                assert tw.dtype == torch.bfloat16, key
                np.testing.assert_array_equal(tw.view(torch.int16).numpy().view(np.uint16),
                                              np.asarray(jw).view(np.uint16))


def test_params_from_jax_checks_moe_layout():
    cfg = tprobe.TransformerConfig(dtype=torch.bfloat16, **MOE_FLAGSHIP)
    moe_tree = jax.tree.map(np.asarray,
                            jprobe.init_params(_jax_cfg(cfg), jax.random.key(0)))
    dense_cfg = dataclasses.replace(cfg, n_experts=None)
    dense_tree = jax.tree.map(np.asarray,
                              jprobe.init_params(_jax_cfg(dense_cfg), jax.random.key(0)))
    # A wrong key set names both blocks, either way round.
    for tree, c in ((dense_tree, cfg), (moe_tree, dense_cfg)):
        with pytest.raises(ValueError, match="dense .*'w2'.*MoE .*'router'"):
            params_from_jax(tree, c, "cpu")
    # A router in another dtype than float32 is refused.
    blocks = [dict(b, router=b["router"].astype(jnp.bfloat16)) for b in moe_tree["blocks"]]
    with pytest.raises(ValueError, match=r"blocks\[0\]\.router is torch.bfloat16, "
                                         r"config says torch.float32"):
        params_from_jax(dict(moe_tree, blocks=blocks), cfg, "cpu")
    # Experts that do not match n_experts are refused.
    with pytest.raises(ValueError, match="stacked experts"):
        params_from_jax(moe_tree, dataclasses.replace(cfg, n_experts=8), "cpu")


def test_moe_init_params_layout_matches_reference():
    cfg = tprobe.TransformerConfig(dtype=torch.bfloat16, **MOE_FLAGSHIP)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jprobe.init_params(_jax_cfg(cfg), jax.random.key(0))
    for tb, jb in zip(params["blocks"], want["blocks"], strict=True):
        assert {k: (tuple(v.shape), v.dtype) for k, v in tb.items()} == {
            k: (v.shape, torch.float32 if k == "router" else torch.bfloat16)
            for k, v in jb.items()}


def test_init_params_layout_matches_reference():
    cfg = tprobe.TransformerConfig(dtype=torch.float32, n_kv_heads=2,
                                   **SMALL)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jprobe.init_params(_jax_cfg(cfg), jax.random.key(0))
    assert params["embed"].shape == want["embed"].shape
    assert params["pos"].shape == want["pos"].shape
    for tb, jb in zip(params["blocks"], want["blocks"], strict=True):
        assert {k: tuple(v.shape) for k, v in tb.items()} == {
            k: v.shape for k, v in jb.items()}
    assert 0.015 < params["blocks"][0]["w1"].std().item() < 0.025


CONFIG_ERRORS = {
    "n_experts_1": dict(n_experts=1),
    "attn_parallel_bogus": dict(attn_parallel="bogus"),
    "seq_with_window": dict(attn_parallel="seq", window=4),
    "d_model_not_divisible": dict(d_model=30),
    "kv_heads_zero": dict(n_kv_heads=0),
    "kv_heads_not_dividing": dict(n_kv_heads=3),
    "window_negative": dict(window=-1),
    "rope_odd_head": dict(d_model=12, n_heads=4, rope=True),
    "rope_base_zero": dict(rope_base=0.0),
}


@pytest.mark.parametrize("case", list(CONFIG_ERRORS))
def test_config_checks_match_reference(case):
    kwargs = CONFIG_ERRORS[case]
    with pytest.raises(ValueError) as want:
        jprobe.TransformerConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        tprobe.TransformerConfig(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [dict(attn_parallel="seq")])
def test_unported_config_options_raise(kwargs):
    """The options the port refused with NotImplementedError until their
    modules were ported. attn_parallel="seq" (ring attention) is ported
    now: the port takes it as the reference does, and no option is left
    that the reference takes and the port refuses."""
    want = jprobe.TransformerConfig(**kwargs)  # valid in the reference
    got = tprobe.TransformerConfig(**kwargs)
    assert all(getattr(got, key) == getattr(want, key) for key in kwargs)


def test_entry_runs_on_cpu():
    fn, args = entry(device="cpu")
    logits = fn(*args)
    assert logits.shape == (4, 32, 256) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
